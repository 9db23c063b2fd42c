"""Batched aggregation engine: shape-bucketed leaf packing + one call per bucket.

Port of ``repro/core/engine.py``:

  1. ``pack`` walks a stacked delta tree once, turns each leaf into its
     (modules, vec_dim, n_clients) matrices, zero-pads vec_dim up to a
     canonical bucket size and concatenates everything that shares a
     ``(padded_vec, n_clients, dtype)`` key into one bucket tensor.  The
     returned ``PackSpec`` is invertible (``unpack``).
  2. Every method runs as one batched call per bucket — a mean, a batched
     TIES election, or one ``robust_pca_bucket`` loop whose tail is the CUDA
     kernels on the card.
  3. Per-module diagnostics come back as (modules,) tensors keyed by bucket.

Zero padding is lossless: zero rows add nothing to means, Gram matrices,
TIES elections or FedExP norms, stay exactly zero through the SVT and the
shrink, and the ADMM constants use each module's true vec dim.  ``mesh=`` (a
``launch.mesh.ClientMesh`` of more than one shard) runs fedrpca's RPCA as
``rpca.robust_pca_bucket_sharded``.

Cross-round sessions split aggregation into a plan (``plan_aggregation``:
the packing and a two-tier layout per bucket, built once) and a step
(``aggregate_planned``) that takes and returns an ``AggCarry`` of
per-tier ``rpca.BucketCarry`` states; ``AggSession`` drives both and
re-tiers on a cadence (``plan_retier``, ``migrate_carry``).

While tracing (``utils.trace``), ``repro.agg.call`` spans a session step,
with ``repro.engine.pack``, ``repro.engine.tier`` (one bucket tier's RPCA)
and ``repro.engine.unpack`` inside it; the copies of host values to the card
count as host syncs (``sync.pack_dims``, ``tier_index``, ``uplink_bytes``).
"""
from __future__ import annotations

import dataclasses
import functools
import warnings
from typing import Any, Callable, Mapping

import torch

from repro_torch.core import rpca as rpca_lib
from repro_torch.core import stacking
from repro_torch.core.aggregators import (
    CARRY_MODES,
    AggregatorConfig,
    _client_weights,
    _dare_leaves,
    _fedexp_eta,
    _is_ab_node,
    _ties_elect,
    sparse_energy_ratio,
)
from repro_torch.kernels import backend
from repro_torch.utils import trace
from repro_torch.utils.pytree import tree_leaves, tree_to, tree_unflatten

Tree = Any

# Bucket key: (padded_vec_dim, n_clients, dtype_name).
BucketKey = tuple


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


@dataclasses.dataclass(frozen=True)
class PackEntry:
    """One packed tree node: a plain leaf or a joint (A, B) adapter pair."""

    kind: str  # "leaf" | "ab_pair"
    path: tuple  # tree path of dict keys / sequence indices
    bucket: BucketKey
    offset: int  # first module row of this entry within its bucket
    n_modules: int
    vec_dim: int  # true (unpadded) vec dim; ab_pair: va + vb
    shapes: tuple  # per-part one-client delta shapes (1 part, or A and B)
    dtypes: tuple  # matching per-part dtypes
    split: tuple  # vec-dim split points between parts (ab_pair: (va,))


@dataclasses.dataclass(frozen=True)
class PackSpec:
    """Static, invertible description of one packing (the unpack program)."""

    entries: tuple
    skeleton: Any  # original structure with entry indices at leaf positions
    n_clients: int  # original (pre-padding) cohort size
    bucket_dims: Mapping[BucketKey, tuple]  # key -> (total_modules, padded_vec)
    cohort_size: int = 0  # padded client-axis length
    # Declared per-client LoRA ranks of a heterogeneous cohort (None =
    # uniform).  A descriptor only: the rank masks are applied to the deltas
    # before packing (``fed.partition.client_rank_masks``).
    client_ranks: tuple | None = None


@dataclasses.dataclass(frozen=True)
class Bucket:
    """One shape bucket: the packed tensor + per-module true vec dims, with
    the cohort validity mask and normalized weights (None on the dense
    unweighted path; masked columns of ``data`` are already zero)."""

    data: torch.Tensor  # (total_modules, padded_vec, cohort_size)
    true_dims: torch.Tensor  # (total_modules,) int32
    dims: tuple = ()  # the same true dims as Python ints
    client_mask: torch.Tensor | None = None  # (cohort_size,) float32
    weights: torch.Tensor | None = None  # (cohort_size,) float32, normalized


@trace.traced("repro.engine.pack")
def pack(
    stacked: Tree,
    *,
    granularity: str = "module",
    joint_ab: bool = False,
    client_mask=None,
    weights=None,
    cohort_size: int | None = None,
    mesh=None,
) -> tuple[dict, PackSpec]:
    """Pack a stacked client-delta tree into shape buckets.

    ``granularity="module"`` splits scan-stacked leaves along their layer
    axes (the fedrpca layout); ``"leaf"`` keeps each leaf one flattened
    matrix.  ``joint_ab`` concatenates each ``{"A", "B"}`` node's vec dims
    into one joint matrix (App. B.2).  ``client_mask`` zeroes padded client
    columns; ``weights`` ride on the buckets; ``cohort_size`` zero-pads the
    client axis and extends the mask with zeros.  ``mesh`` places nothing:
    the sharded loop owns the column layout, and a one-shard mesh is the
    unsharded packing.
    """
    if granularity not in ("module", "leaf"):
        raise ValueError(f"unknown granularity: {granularity!r}")
    leaves = tree_leaves(stacked)
    if not leaves:
        raise ValueError("pack: empty pytree")
    dev = leaves[0].device
    orig_clients = None
    if cohort_size is not None:
        orig_clients = int(leaves[0].shape[0])
        pad_c = cohort_size - orig_clients
        if pad_c < 0:
            raise ValueError(f"cohort_size {cohort_size} < client count {orig_clients}")
        if pad_c:
            stacked = stacking.pad_cohort(stacked, cohort_size)
            zeros = torch.zeros((pad_c,), dtype=torch.float32, device=dev)
            base = (
                torch.ones((orig_clients,), dtype=torch.float32, device=dev)
                if client_mask is None
                else torch.as_tensor(client_mask, dtype=torch.float32, device=dev)
            )
            client_mask = torch.cat([base, zeros])
            if weights is not None:
                weights = torch.cat(
                    [torch.as_tensor(weights, dtype=torch.float32, device=dev), zeros]
                )
    entries: list[PackEntry] = []
    mats_by_bucket: dict[BucketKey, list] = {}
    dims_by_bucket: dict[BucketKey, list] = {}
    offsets: dict[BucketKey, int] = {}
    n_clients_seen: list[int] = []

    def add_matrices(mats, vec_dim, dtype):
        nc = mats.shape[-1]
        n_clients_seen.append(nc)
        padded = stacking.canonical_vec_dim(vec_dim)
        key = (padded, nc, _dtype_name(dtype))
        off = offsets.get(key, 0)
        mats_by_bucket.setdefault(key, []).append(
            stacking.pad_matrices(mats.to(dtype), padded)
        )
        dims_by_bucket.setdefault(key, []).extend([vec_dim] * mats.shape[0])
        offsets[key] = off + mats.shape[0]
        return key, off

    def walk(node, path):
        if joint_ab and _is_ab_node(node):
            a, b = node["A"], node["B"]
            mats_a = stacking.leaf_matrices(a)
            mats_b = stacking.leaf_matrices(b)
            if mats_a.shape[0] != mats_b.shape[0]:
                raise ValueError(
                    f"(A, B) module counts differ at {path}: "
                    f"{mats_a.shape[0]} vs {mats_b.shape[0]}"
                )
            dtype = torch.promote_types(a.dtype, b.dtype)
            joint = torch.cat([mats_a.to(dtype), mats_b.to(dtype)], dim=1)
            key, off = add_matrices(joint, joint.shape[1], dtype)
            entries.append(PackEntry(
                kind="ab_pair", path=path, bucket=key, offset=off,
                n_modules=joint.shape[0], vec_dim=joint.shape[1],
                shapes=(tuple(a.shape[1:]), tuple(b.shape[1:])),
                dtypes=(a.dtype, b.dtype), split=(mats_a.shape[1],),
            ))
            return len(entries) - 1
        if isinstance(node, dict):
            return {k: walk(v, path + (k,)) for k, v in node.items()}
        if isinstance(node, (list, tuple)):
            walked = [walk(v, path + (i,)) for i, v in enumerate(node)]
            if hasattr(node, "_fields"):
                return type(node)(*walked)
            return type(node)(walked)
        layer_axes = None if granularity == "module" else 0
        mats = stacking.leaf_matrices(node, layer_axes)
        key, off = add_matrices(mats, mats.shape[1], node.dtype)
        entries.append(PackEntry(
            kind="leaf", path=path, bucket=key, offset=off,
            n_modules=mats.shape[0], vec_dim=mats.shape[1],
            shapes=(tuple(node.shape[1:]),), dtypes=(node.dtype,), split=(),
        ))
        return len(entries) - 1

    skeleton = walk(stacked, ())
    if len(set(n_clients_seen)) != 1:
        raise ValueError(f"inconsistent client counts across leaves: {set(n_clients_seen)}")

    mask32 = None if client_mask is None else torch.as_tensor(
        client_mask, dtype=torch.float32, device=dev)
    w32 = None if weights is None else torch.as_tensor(weights, dtype=torch.float32, device=dev)

    def build(mats, key):
        data = torch.cat(mats, dim=0)
        if mask32 is not None:
            data = data * mask32.to(data.dtype)
        return Bucket(
            data=data,
            true_dims=trace.to_device(dims_by_bucket[key], "pack_dims", dev, torch.int32),
            dims=tuple(dims_by_bucket[key]),
            client_mask=mask32,
            weights=w32,
        )

    buckets = {key: build(mats, key) for key, mats in mats_by_bucket.items()}
    spec = PackSpec(
        entries=tuple(entries),
        skeleton=skeleton,
        n_clients=orig_clients if orig_clients is not None else n_clients_seen[0],
        bucket_dims={k: (b.data.shape[0], b.data.shape[1]) for k, b in buckets.items()},
        cohort_size=n_clients_seen[0],
    )
    return buckets, spec


@trace.traced("repro.engine.unpack")
def unpack(spec: PackSpec, updates: Mapping[BucketKey, torch.Tensor]) -> Tree:
    """Invert ``pack``: per-bucket (total_modules, padded_vec) update arrays
    back to a tree shaped like one client's delta."""

    def rebuild(skel):
        if isinstance(skel, int):
            e = spec.entries[skel]
            rows = updates[e.bucket][e.offset : e.offset + e.n_modules, : e.vec_dim]
            if e.split:
                bounds = [0, *e.split, rows.shape[1]]
                parts = [rows[:, lo:hi] for lo, hi in zip(bounds, bounds[1:])]
            else:
                parts = [rows]
            outs = [p.reshape(shp).to(dt) for p, shp, dt in zip(parts, e.shapes, e.dtypes)]
            if e.kind == "ab_pair":
                return {"A": outs[0], "B": outs[1]}
            return outs[0]
        if isinstance(skel, dict):
            return {k: rebuild(v) for k, v in skel.items()}
        if hasattr(skel, "_fields"):
            return type(skel)(*(rebuild(v) for v in skel))
        return type(skel)(rebuild(v) for v in skel)

    return rebuild(spec.skeleton)


# ---------------------------------------------------------------------------
# Diagnostics
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class EngineDiagnostics:
    """Per-module diagnostic tensors keyed by PackSpec bucket; ``spec`` maps
    rows back to tree paths, ``scalars`` holds whole-round scalars."""

    spec: PackSpec
    arrays: Mapping[str, Mapping[BucketKey, torch.Tensor]]
    scalars: Mapping[str, torch.Tensor] = dataclasses.field(default_factory=dict)

    def flat(self, name: str) -> torch.Tensor:
        """All modules' values for one diagnostic, bucket order."""
        return torch.cat(list(self.arrays[name].values()))

    def mean(self, name: str) -> torch.Tensor:
        return torch.mean(self.flat(name))

    def max(self, name: str) -> torch.Tensor:
        return torch.max(self.flat(name))

    def per_entry(self, name: str) -> dict:
        """Regroup a diagnostic by tree path: {"/".join(path): (modules,)}."""
        out = {}
        for e in self.spec.entries:
            arr = self.arrays[name][e.bucket][e.offset : e.offset + e.n_modules]
            out["/".join(str(p) for p in e.path)] = arr
        return out


# ---------------------------------------------------------------------------
# Batched per-bucket aggregators
# ---------------------------------------------------------------------------


def _bucket_mean(bucket: Bucket) -> torch.Tensor:
    """Mean over the client axis: unweighted, or the normalized weighted sum
    accumulated in float32."""
    if bucket.weights is None:
        return torch.mean(bucket.data, dim=-1)
    return (bucket.data.to(torch.float32) @ bucket.weights).to(bucket.data.dtype)


def _ties_bucket(data: torch.Tensor, dims: tuple, keep: float, scale: float, w=None):
    """Batched TIES (trim, elect sign, disjoint mean) over one (B, d, nc)
    bucket.  Each module's k is the host-side ``max(int(keep * d), 1)`` of
    its true vec dim, as on the per-leaf path; one ``torch.topk`` at the
    bucket's largest k gives every module its own k-th value.  Padded zeros
    never survive the trim."""
    b, _, nc = data.shape
    flat = data.mT.to(torch.float32)  # (B, nc, d)
    k_list = [max(int(keep * di), 1) for di in dims]
    absx = torch.abs(flat)
    topv = torch.topk(absx, max(k_list), dim=-1).values  # descending
    kth_idx = torch.tensor([k - 1 for k in k_list], device=data.device)
    kth = torch.gather(topv, 2, kth_idx[:, None, None].expand(b, nc, 1))
    trimmed = torch.where(absx >= kth, flat, 0.0)
    wc = None if w is None else w[None, :, None]
    return scale * _ties_elect(trimmed, 1, wc)


def _fedrpca_bucket(
    bucket: Bucket,
    cfg,
    shrink_fn: Callable,
    carry=None,
    svt_rank: int | None = None,
    mesh=None,
    uplink=None,
    true_cols: int | None = None,
):
    """FedRPCA over one bucket in one ``robust_pca_bucket`` call, or one
    ``robust_pca_bucket_sharded`` call on a multi-shard ``mesh``:
    ((B, vec) update, diagnostics, new carry).

    ``uplink`` (an active ``fed.sketch.UplinkConfig``, carry required)
    replaces the client columns by their sketch round trip against the
    carry's basis when the carry is valid and no module's dropped energy
    exceeds ``energy_tol``.  The gate is a device tensor and the choice a
    ``torch.where`` (no host read); a tripped gate is the dense columns
    bit for bit.  The diagnostics then gain ``uplink_bytes_up``,
    ``uplink_bytes_down`` and ``uplink_hit``.

    ``carry`` is this bucket tier's ``BucketCarry`` (None: the stateless
    call, and the returned carry is None); ``svt_rank`` overrides the
    config's cap, as the low tier of a re-tiered plan does.

    The mask rides into the RPCA (n_eff constants, masked tail) and the
    column means become weighted sums over active clients.
    ``weighting="data_size_rpca"`` column-scales the bucket by the
    n_eff-normalized weights before the split and takes uniform means over
    active clients after it, as the reference's ``col_scale`` branch does.
    """
    m = bucket.data.to(torch.float32)
    col_scaled = cfg.weighting == "data_size_rpca" and bucket.weights is not None
    if bucket.client_mask is None:
        n_eff = float(m.shape[-1])
        w_uniform = None
    else:
        n_eff = torch.clamp_min(torch.sum(bucket.client_mask), 1.0)
        w_uniform = bucket.client_mask / n_eff
    uplink_diag = {}
    if uplink is not None and uplink.active and carry is not None:
        from repro_torch.fed import sketch as sketch_lib

        basis = sketch_lib.uplink_basis(carry.l, carry.v)
        sk = sketch_lib.encode_delta(m, basis, uplink.k)
        m_hat = sketch_lib.decode_into_bucket(sk, basis)
        use_sketch = carry.valid & (torch.amax(sk.energy_frac) <= uplink.energy_tol)
        m = torch.where(use_sketch, m_hat, m)
        b_mod, d1, r = basis.shape
        kk = min(int(uplink.k), d1)
        dense_b = sketch_lib.dense_bytes_per_client(bucket.dims)
        sketch_b = sketch_lib.sketch_bytes_per_client(b_mod, r, kk)
        hit = use_sketch.to(torch.float32)
        per_client = torch.where(use_sketch, trace.to_device(sketch_b, "uplink_bytes", m.device),
                                 trace.to_device(dense_b, "uplink_bytes", m.device))
        uplink_diag = {
            "uplink_bytes_up": per_client * n_eff,
            "uplink_bytes_down": trace.to_device(sketch_lib.basis_bytes(b_mod, d1, r),
                                                 "uplink_bytes", m.device, torch.float32),
            "uplink_hit": hit,
        }
    if col_scaled:
        m = m * (bucket.weights * n_eff)[None, None, :]
    rpca_fn = rpca_lib.robust_pca_bucket
    rpca_kwargs = {}
    if rpca_lib.mesh_client_shards(mesh) > 1:
        rpca_fn = rpca_lib.robust_pca_bucket_sharded
        rpca_kwargs = {"mesh": mesh, "mesh_overlap": cfg.mesh_overlap}
    res = rpca_fn(
        m,
        bucket.true_dims,
        n_iter=cfg.rpca_iters,
        tol=None if cfg.rpca_fixed_iters else cfg.rpca_tol,
        shrink_fn=shrink_fn,
        client_mask=bucket.client_mask,
        svt_mode=cfg.svt_mode,
        svt_rank=cfg.svt_rank if svt_rank is None else svt_rank,
        svt_sweeps=cfg.svt_sweeps,
        svt_fallback_tol=cfg.svt_fallback_tol,
        carry=carry,
        return_carry=carry is not None,
        carry_gate=cfg.carry_gate,
        true_cols=true_cols,
        **rpca_kwargs,
    )
    new_carry = None
    if carry is not None:
        res, new_carry = res
    w_post = w_uniform if col_scaled else bucket.weights
    diag_extra = {}
    if cfg.guard_energy_k > 0:
        client_energy = rpca_lib.client_sparse_energy(m, res.sparse)
        gw, flags = rpca_lib.energy_guard_weights(
            client_energy, cfg.guard_energy_k, base_w=w_post, valid=bucket.client_mask,
        )
        low_mean = torch.einsum("mvc,mc->mv", res.low_rank, gw)
        sparse_mean = torch.einsum("mvc,mc->mv", res.sparse, gw)
        diag_extra = {
            "client_energy": torch.amax(client_energy, dim=0),
            "client_flagged": torch.amax(flags, dim=0),
        }
    elif w_post is None:
        low_mean = torch.mean(res.low_rank, dim=-1)
        sparse_mean = torch.mean(res.sparse, dim=-1)
    else:
        low_mean = res.low_rank @ w_post
        sparse_mean = res.sparse @ w_post
    energy = sparse_energy_ratio(m, res.sparse)
    if cfg.adaptive_beta:
        beta = torch.clamp(1.0 / torch.clamp_min(energy, 1e-12), cfg.beta_min, cfg.beta_max)
    else:
        beta = torch.full(energy.shape, cfg.beta, dtype=torch.float32, device=m.device)
    update = low_mean + beta[:, None] * sparse_mean
    diag = {
        "beta": beta, "energy": energy, "residual": res.residual, **diag_extra,
        **uplink_diag,
    }
    return update, diag, new_carry


def _dare_rescale(stacked: Tree, drop_rate: float, key, mask=None) -> Tree:
    """Per-leaf DARE drop and rescale, drawing the per-leaf path's keep
    masks (``aggregators._dare_keep``)."""
    return tree_unflatten(stacked, _dare_leaves(stacked, drop_rate, key, mask))


def aggregate_packed(
    stacked: Tree,
    cfg=None,
    *,
    shrink_fn: Callable = rpca_lib.soft_threshold,
    key=None,
    mask=None,
    weights=None,
    with_diagnostics: bool = False,
    mesh=None,
):
    """Aggregate stacked client deltas with one batched call per bucket.

    Same methods and results as the per-leaf reference path.  ``mask`` /
    ``weights`` are the cohort validity mask and raw weights; masked bucket
    columns are zeroed at pack time.  Diagnostics of fedrpca come back as
    an ``EngineDiagnostics``.

    ``mesh`` shards every bucket's client axis for fedrpca; the other
    methods do not depend on it.  A one-shard mesh is the unsharded call,
    bit for bit.  ``key`` seeds dare.
    """
    cfg = cfg or AggregatorConfig()
    method = cfg.method
    dev = tree_leaves(stacked)[0].device
    mask32 = None if mask is None else torch.as_tensor(mask, dtype=torch.float32, device=dev)
    w = _client_weights(mask32, weights, dev)
    if method == "dare":
        stacked = _dare_rescale(stacked, cfg.dare_drop, key, mask=mask32)
    granularity = "leaf" if method == "ties" else "module"
    joint = method == "fedrpca" and cfg.joint_ab
    buckets, spec = pack(stacked, granularity=granularity, joint_ab=joint,
                         client_mask=mask32, weights=w)

    updates: dict[BucketKey, torch.Tensor] = {}
    diag_arrays: dict[str, dict] = {}
    if method in ("fedavg", "dare"):
        for bkey, bucket in buckets.items():
            updates[bkey] = _bucket_mean(bucket)
    elif method == "task_arithmetic":
        for bkey, bucket in buckets.items():
            updates[bkey] = (cfg.beta * _bucket_mean(bucket)).to(bucket.data.dtype)
    elif method == "ties":
        for bkey, bucket in buckets.items():
            updates[bkey] = _ties_bucket(
                bucket.data, bucket.dims, cfg.ties_keep, cfg.ties_scale, bucket.weights
            )
    elif method == "fedexp":
        # One extrapolation factor over all buckets; padding and masked
        # columns are zero, so the sums run over active clients only.
        n_eff = spec.n_clients if mask32 is None else torch.clamp_min(torch.sum(mask32), 1.0)
        sum_sq = mean_sq = 0.0
        means = {}
        for bkey, bucket in buckets.items():
            sum_sq = sum_sq + torch.sum(torch.square(bucket.data.to(torch.float32)))
            means[bkey] = _bucket_mean(bucket)
            mean_sq = mean_sq + torch.sum(torch.square(means[bkey].to(torch.float32)))
        eta = _fedexp_eta(sum_sq, mean_sq, n_eff)
        for bkey, mean in means.items():
            updates[bkey] = (eta * mean).to(mean.dtype)
    elif method == "fedrpca":
        names = ("beta", "energy", "residual") + (
            ("client_energy", "client_flagged") if cfg.guard_energy_k > 0 else ()
        )
        diag_arrays = {k: {} for k in names}
        for bkey, bucket in buckets.items():
            updates[bkey], d, _ = _fedrpca_bucket(
                bucket, cfg, shrink_fn, true_cols=spec.n_clients, mesh=mesh
            )
            for k in names:
                diag_arrays[k][bkey] = d[k]
    else:
        raise ValueError(f"unknown aggregation method: {method!r}")

    out = unpack(spec, updates)
    if with_diagnostics:
        if not diag_arrays:
            return out, {}
        return out, EngineDiagnostics(spec=spec, arrays=diag_arrays)
    return out


# ---------------------------------------------------------------------------
# Cross-round aggregation sessions
# ---------------------------------------------------------------------------
#
# The stateless ``aggregate_packed`` cold-starts every bucket's ADMM loop,
# and in subspace mode pays the exact-eigh burn-in every round although the
# client deltas of consecutive rounds are strongly correlated.  A session
# builds an ``AggPlan`` once (packing, two-tier layout) and steps rounds
# through ``aggregate_planned``, which takes and returns an ``AggCarry`` of
# per-tier ``rpca.BucketCarry`` states; a warm round enters the ADMM loop at
# the previous round's fixed point.  The carry's shapes, dtypes and device
# do not change from round to round.

#: AggCarry: {(bucket_key, tier_name): rpca.BucketCarry}.  An empty dict is
#: the carry of a plan without session state (carry_mode="none" or a
#: non-fedrpca method).
AggCarry = dict


@dataclasses.dataclass(frozen=True)
class TierSpec:
    """Two-tier split of one bucket's module rows: ``full_idx`` runs at the
    config's ``svt_rank`` cap, ``low_idx`` (converged to a small live rank)
    at the tighter ``low_cap``.  Either side may be empty."""

    low_idx: tuple = ()
    full_idx: tuple = ()
    low_cap: int = 0

    def tiers(self):
        """Non-empty (name, module_idx, rank_cap_or_None) tiers."""
        out = []
        if self.full_idx:
            out.append(("full", self.full_idx, None))
        if self.low_idx:
            out.append(("low", self.low_idx, self.low_cap))
        return out


@dataclasses.dataclass(frozen=True)
class AggPlan:
    """What a session fixes once: the invertible ``PackSpec``, the packing,
    the per-bucket tiers, whether a carry threads, the mesh (None for one
    shard) and the device its carries live on."""

    cfg: AggregatorConfig
    spec: PackSpec
    granularity: str
    joint_ab: bool
    carry: bool  # whether a step threads an AggCarry
    tiers: Mapping[BucketKey, TierSpec]
    mesh: Any = None
    device: Any = None  # where init_agg_carry puts the carries
    # Uplink codec (``fed.sketch.UplinkConfig``); None never enters the
    # codec.  Only a carrying plan sketches: the codec projects onto the
    # carried basis.
    uplink: Any = None


def _plan_carry(cfg) -> bool:
    if cfg.carry_mode not in CARRY_MODES:
        raise ValueError(
            f"unknown carry_mode: {cfg.carry_mode!r} (expected one of {CARRY_MODES})"
        )
    if cfg.carry_mode == "none" or cfg.method != "fedrpca":
        return False
    if cfg.carry_mode == "subspace" and cfg.svt_mode != "subspace":
        raise ValueError(
            'carry_mode="subspace" persists the subspace-SVT eigenbasis and '
            'requires svt_mode="subspace"; use carry_mode="full" to carry '
            "bare ADMM iterates under gram mode"
        )
    return True


def plan_aggregation(
    stacked: Tree,
    cfg=None,
    *,
    cohort_size: int | None = None,
    mesh=None,
    uplink=None,
    client_ranks=None,
) -> AggPlan:
    """The plan for aggregating trees shaped like ``stacked`` (only its
    structure, shapes, dtypes and device matter).  Every bucket starts in
    one burn-in tier; ``plan_retier`` moves converged modules to a low
    tier.  A one-shard ``mesh`` is normalized to None, the unsharded path.
    Carries live on the mesh's first device, else on ``stacked``'s.

    ``uplink`` is the codec config (a ``fed.sketch.UplinkConfig`` or a spec
    for ``fed.sketch.parse_uplink``).  Dense or None plans never enter the
    codec; sketch mode on a plan without a carry warns and runs dense.
    ``client_ranks`` records the cohort's declared ranks on the
    ``PackSpec`` (a descriptor: the rank masks are applied upstream)."""
    cfg = cfg or AggregatorConfig()
    if rpca_lib.mesh_client_shards(mesh) == 1:
        mesh = None
    granularity = "leaf" if cfg.method == "ties" else "module"
    joint = cfg.method == "fedrpca" and cfg.joint_ab
    _, spec = pack(stacked, granularity=granularity, joint_ab=joint, cohort_size=cohort_size)
    if client_ranks is not None:
        spec = dataclasses.replace(spec, client_ranks=tuple(int(r) for r in client_ranks))
    carry = _plan_carry(cfg)
    if uplink is not None:
        from repro_torch.fed import sketch as sketch_lib

        uplink = sketch_lib.parse_uplink(uplink)
        if uplink.active and not carry:
            warnings.warn(
                "uplink sketch mode needs a carrying fedrpca plan (the codec "
                "projects onto the carried basis); running dense",
                stacklevel=2,
            )
            uplink = None
        elif not uplink.active:
            uplink = None  # dense is the no-codec path
    tiers = {
        key: TierSpec(low_idx=(), full_idx=tuple(range(dims[0])), low_cap=0)
        for key, dims in spec.bucket_dims.items()
    }
    device = mesh.devices[0] if mesh is not None else tree_leaves(stacked)[0].device
    return AggPlan(cfg=cfg, spec=spec, granularity=granularity, joint_ab=joint,
                   carry=carry, tiers=tiers, mesh=mesh, device=device, uplink=uplink)


def init_agg_carry(plan: AggPlan) -> AggCarry:
    """Empty (invalid) carries of the plan's bucket tiers, on its device."""
    if not plan.carry:
        return {}
    out = {}
    for bkey, tier in plan.tiers.items():
        padded_vec, d2 = bkey[0], bkey[1]
        for name, idx, cap in tier.tiers():
            rank = plan.cfg.svt_rank if cap is None else cap
            out[(bkey, name)] = rpca_lib.init_bucket_carry(
                len(idx), padded_vec, d2, rank, true_cols=plan.spec.n_clients,
                device=plan.device,
            )
    return out


def _sub_bucket(bucket: Bucket, idx: tuple) -> Bucket:
    """A tier's module rows of a bucket, gathered into new tensors."""
    ia = trace.to_device(idx, "tier_index", bucket.data.device, torch.int64)
    return Bucket(
        data=bucket.data.index_select(0, ia),
        true_dims=bucket.true_dims.index_select(0, ia),
        dims=tuple(bucket.dims[i] for i in idx),
        client_mask=bucket.client_mask,
        weights=bucket.weights,
    )


@trace.traced("repro.agg.call")
def aggregate_planned(
    plan: AggPlan,
    stacked: Tree,
    carry: AggCarry | None = None,
    *,
    shrink_fn: Callable = rpca_lib.soft_threshold,
    key=None,
    mask=None,
    weights=None,
    with_diagnostics: bool = False,
):
    """One round of a session: ``(update, new_carry)``, plus an
    ``EngineDiagnostics`` with ``with_diagnostics``.  Each bucket tier runs
    as one batched call with its own rank cap and carry slot; fedrpca adds
    per-module ``live_rank`` and the ``fallback_count`` / ``carry_hit_rate``
    scalars when a carry threads; a sketch-uplink plan adds the wire
    scalars ``bytes_up``, ``bytes_down_basis``, ``uplink_hit_rate`` and
    ``uplink_dense_falls``, summed over the bucket tiers.  An empty carry
    with a carrying plan cold-starts every bucket; other methods delegate to
    ``aggregate_packed`` and pass the carry through."""
    cfg = plan.cfg
    if cfg.method != "fedrpca":
        out = aggregate_packed(
            stacked, cfg, shrink_fn=shrink_fn, key=key, mask=mask, weights=weights,
            with_diagnostics=with_diagnostics, mesh=plan.mesh,
        )
        new_carry = {} if carry is None else carry
        if with_diagnostics:
            return out[0], new_carry, out[1]
        return out, new_carry

    dev = tree_leaves(stacked)[0].device
    mask32 = None if mask is None else trace.to_device(mask, "cohort", dev, torch.float32)
    w = _client_weights(mask32, weights, dev)
    buckets, spec = pack(stacked, granularity=plan.granularity, joint_ab=plan.joint_ab,
                         client_mask=mask32, weights=w)
    if dict(spec.bucket_dims) != dict(plan.spec.bucket_dims):
        raise ValueError(
            "stacked tree does not match the session plan "
            f"({dict(spec.bucket_dims)} vs {dict(plan.spec.bucket_dims)}); "
            "re-plan with plan_aggregation for a new tree structure"
        )
    if plan.carry and not carry:
        carry = init_agg_carry(plan)

    client_keys = ("client_energy", "client_flagged") if cfg.guard_energy_k > 0 else ()
    arrays: dict[str, dict] = {
        k: {} for k in ("beta", "energy", "residual")
        + (("live_rank",) if plan.carry else ()) + client_keys
    }
    updates: dict[BucketKey, torch.Tensor] = {}
    new_carry: AggCarry = {}
    falls, hits = [], []
    up_bytes, down_bytes, up_hits = [], [], []

    def run_tier(sub, ck, cap):
        with trace.span("repro.engine.tier"):
            upd, d, c2 = _fedrpca_bucket(
                sub, cfg, shrink_fn, carry=carry.get(ck) if plan.carry else None, svt_rank=cap,
                mesh=plan.mesh, uplink=plan.uplink, true_cols=plan.spec.n_clients,
            )
        if "uplink_bytes_up" in d:
            up_bytes.append(d["uplink_bytes_up"])
            down_bytes.append(d["uplink_bytes_down"])
            up_hits.append(d["uplink_hit"])
        if plan.carry:
            new_carry[ck] = c2
            falls.append(c2.fall_count)
            hits.append(c2.hit)
        return upd, d, c2

    for bkey, bucket in buckets.items():
        b_total, padded_vec = plan.spec.bucket_dims[bkey]
        tiers = plan.tiers[bkey].tiers()
        if len(tiers) == 1 and tiers[0][1] == tuple(range(b_total)):
            # One whole-bucket tier: no gather and scatter.
            name, _, cap = tiers[0]
            upd, d, c2 = run_tier(bucket, (bkey, name), cap)
            per_mod = dict(d)
            if plan.carry:
                per_mod["live_rank"] = c2.n_live.to(torch.float32)
        else:
            upd = torch.zeros((b_total, padded_vec), dtype=torch.float32, device=dev)
            per_mod = {k: torch.zeros((b_total,), dtype=torch.float32, device=dev)
                       for k in arrays if k not in client_keys}
            for name, idx, cap in tiers:
                u_t, d_t, c2 = run_tier(_sub_bucket(bucket, idx), (bkey, name), cap)
                ia = trace.to_device(idx, "tier_index", dev, torch.int64)
                upd[ia] = u_t.to(torch.float32)
                for k in ("beta", "energy", "residual"):
                    per_mod[k][ia] = d_t[k]
                for k in client_keys:
                    per_mod[k] = d_t[k] if k not in per_mod else torch.maximum(per_mod[k], d_t[k])
                if plan.carry:
                    per_mod["live_rank"][ia] = c2.n_live.to(torch.float32)
        updates[bkey] = upd
        for k in arrays:
            arrays[k][bkey] = per_mod[k]

    out = unpack(spec, updates)
    if not with_diagnostics:
        return out, new_carry
    scalars = {}
    if plan.carry:
        scalars = {
            "fallback_count": functools.reduce(lambda a, b: a + b, falls),
            "carry_hit_rate": torch.mean(torch.stack(hits)),
        }
    if up_bytes:
        total = lambda xs: functools.reduce(lambda a, b: a + b, xs)
        hit_t = torch.stack(up_hits)
        scalars["bytes_up"] = total(up_bytes)
        scalars["bytes_down_basis"] = total(down_bytes)
        scalars["uplink_hit_rate"] = torch.mean(hit_t)
        scalars["uplink_dense_falls"] = torch.sum(1.0 - hit_t)
    return out, new_carry, EngineDiagnostics(spec=spec, arrays=arrays, scalars=scalars)


def plan_retier(plan: AggPlan, carry: AggCarry, *, margin: int | None = None) -> AggPlan:
    """Two-tier re-pack, read from the carry's live ranks on the host: a
    module whose live rank sits at least ``margin + 1`` below the full cap
    joins the low tier, whose cap is its members' largest live rank plus
    ``margin``.  A bucket with an invalid carry, or nothing worth splitting,
    keeps one tier.  Returns a new plan; call it on a cadence
    (``AggregatorConfig.retier_every``), not every round."""
    cfg = plan.cfg
    if not plan.carry:
        return plan
    margin = cfg.retier_margin if margin is None else margin
    new_tiers = {}
    for bkey, tier in plan.tiers.items():
        b_total = plan.spec.bucket_dims[bkey][0]
        r_full = rpca_lib.subspace_rank(bkey[1], cfg.svt_rank, plan.spec.n_clients)
        single = TierSpec(low_idx=(), full_idx=tuple(range(b_total)), low_cap=0)
        n_live = [0] * b_total
        ok = True
        for name, idx, _cap in tier.tiers():
            c = carry.get((bkey, name))
            if c is None or not trace.host_read(c.valid, "retier"):
                ok = False
                break
            for mod, nl in zip(idx, trace.host_read(c.n_live, "retier", torch.Tensor.tolist)):
                n_live[mod] = int(nl)
        if not ok:
            new_tiers[bkey] = single
            continue
        lows = tuple(i for i in range(b_total) if 0 < n_live[i] + margin < r_full)
        low_cap = max((n_live[i] for i in lows), default=0) + margin
        if not lows or low_cap >= r_full:
            new_tiers[bkey] = single
            continue
        fulls = tuple(i for i in range(b_total) if i not in set(lows))
        new_tiers[bkey] = TierSpec(low_idx=lows, full_idx=fulls, low_cap=low_cap)
    return dataclasses.replace(plan, tiers=new_tiers)


def migrate_carry(old_plan: AggPlan, old_carry: AggCarry, new_plan: AggPlan) -> AggCarry:
    """Re-key a carry onto a re-tiered plan (same ``PackSpec``).  Module rows
    move with their modules; each basis keeps its trailing columns (``eigh``
    sorts ascending, so those are the top directions) or is front-padded
    with identity columns to the new width.  Validity transfers, so the
    migrated tiers warm-start; a basis the slice spoiled is caught by the
    subspace fallback gate."""
    if not new_plan.carry:
        return {}
    if not old_carry:
        return init_agg_carry(new_plan)
    out = init_agg_carry(new_plan)
    for bkey, new_tier in new_plan.tiers.items():
        by_mod, meta = {}, None
        for name, idx, _cap in old_plan.tiers[bkey].tiers():
            c = old_carry.get((bkey, name))
            if c is None:
                continue
            meta = c
            for i, mod in enumerate(idx):
                by_mod[mod] = (c.l[i], c.s[i], c.y[i], c.v[i], c.n_live[i])
        if meta is None:
            continue
        for name, idx, _cap in new_tier.tiers():
            ck = (bkey, name)
            if any(mod not in by_mod for mod in idx):
                continue  # this tier keeps its invalid zero carry
            r_new = out[ck].v.shape[-1]

            def fit_basis(v):
                r_old = v.shape[-1]
                if r_old >= r_new:
                    return v[:, r_old - r_new:]
                pad = torch.eye(v.shape[0], r_new - r_old, dtype=v.dtype, device=v.device)
                return torch.cat([pad, v], dim=-1)

            stack = lambda j: torch.stack([by_mod[mod][j] for mod in idx])
            out[ck] = rpca_lib.BucketCarry(
                l=stack(0), s=stack(1), y=stack(2),
                v=torch.stack([fit_basis(by_mod[mod][3]) for mod in idx]).contiguous(),
                n_live=torch.clamp_max(stack(4), r_new).to(torch.int32),
                n_eff=meta.n_eff, valid=meta.valid,
                fall_count=torch.zeros_like(meta.fall_count),
                hit=torch.zeros_like(meta.hit),
            )
    return out


class AggSession:
    """Cross-round aggregation: plan once, step every round.

        session = AggSession(AggregatorConfig(
            method="fedrpca", svt_mode="subspace", carry_mode="subspace"))
        for round_tree in rounds:
            update, diag = session.step(round_tree)

    ``step`` plans on its first call, re-tiers every ``cfg.retier_every``
    rounds (0 = never) and threads the carry.  It runs on ``device``
    (``"cuda"`` unless the caller asks for the CPU), or on the first device
    of a multi-shard ``mesh``, whose device type must be ``device``'s; the
    round's tree, mask and weights move there, as in ``aggregate``.
    """

    def __init__(self, cfg=None, *, shrink_fn: Callable = rpca_lib.soft_threshold,
                 mesh=None, uplink=None, device="cuda"):
        self.cfg = cfg or AggregatorConfig()
        self.shrink_fn = shrink_fn
        self.device = backend.resolve_device(device)
        if rpca_lib.mesh_client_shards(mesh) > 1:
            if mesh.devices[0].type != self.device.type:
                raise ValueError(f"a mesh on {mesh.devices[0]} cannot aggregate on {self.device}")
            self.device = mesh.devices[0]
        self.mesh = mesh
        self.uplink = uplink
        self.plan: AggPlan | None = None
        self.carry: AggCarry = {}
        self.round_idx = 0

    def reset(self):
        """Drop all cross-round state: the next step cold-starts."""
        if self.plan is not None:
            self.carry = init_agg_carry(self.plan)
        self.round_idx = 0

    def retier(self):
        """Re-evaluate the two-tier split now and migrate the carry."""
        new_plan = plan_retier(self.plan, self.carry)
        if new_plan.tiers != self.plan.tiers:
            self.carry = migrate_carry(self.plan, self.carry, new_plan)
            self.plan = new_plan

    def step(self, stacked, *, key=None, mask=None, weights=None):
        """Aggregate one round's stacked deltas: ``(update, diag)``."""
        stacked = tree_to(stacked, self.device)
        mask = None if mask is None else torch.as_tensor(mask, device=self.device)
        weights = None if weights is None else torch.as_tensor(weights, device=self.device)
        if self.plan is None:
            self.plan = plan_aggregation(stacked, self.cfg, mesh=self.mesh, uplink=self.uplink)
            self.carry = init_agg_carry(self.plan)
        elif (self.cfg.retier_every and self.round_idx
              and self.round_idx % self.cfg.retier_every == 0):
            self.retier()
        out, self.carry, diag = aggregate_planned(
            self.plan, stacked, self.carry, shrink_fn=self.shrink_fn, key=key, mask=mask,
            weights=weights, with_diagnostics=True,
        )
        self.round_idx += 1
        return out, diag
