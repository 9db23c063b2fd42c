"""Port aggregation against the JAX package: packing, every ported method on
both engines (dense, masked, weighted, joint A/B), packed == reference
inside the port, and the numpy bridge of ``repro_torch.convert``.

Updates are held to atol 1e-5 * max|delta| (fp32; RPCA adds eigh round-off
over its iterations, the means only reassociate sums).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.core import aggregate as jaggregate
from repro.core import rpca_diag_summary as jsummary
from repro_torch.convert import from_jax_tree, to_numpy_tree
from repro_torch.core import METHODS, AggregatorConfig, aggregate, rpca_diag_summary
from repro_torch.core.aggregators import AggregatorConfig as PortConfig
from repro_torch.core.engine import pack, unpack
from repro_torch.utils.pytree import tree_leaves, tree_map


def planted_tree(seed, nc, rank=2):
    """Mixed-shape stacked delta tree: a scan-stacked (A, B) pair, a module
    sharing their bucket, and an odd-sized leaf in another bucket, each a
    low-rank client core plus sparse spikes."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        vec = int(np.prod(s[1:]))
        low = rng.normal(size=(vec, rank)) @ rng.normal(size=(rank, nc))
        sp = np.where(rng.random((vec, nc)) < 0.05, 5.0 * rng.normal(size=(vec, nc)), 0.0)
        return np.moveaxis(low + sp, -1, 0).reshape(s).astype(np.float32)

    return {
        "blocks": {"attn": {"A": mk(nc, 4, 6, 8), "B": mk(nc, 4, 8, 6)}},
        "head": mk(nc, 12, 4),
        "odd": mk(nc, 10, 10),
    }


def assert_tree_close(got, want, scale):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(
            np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=0, atol=1e-5 * scale
        )


def test_config_fields_match_reference():
    jf = [(f.name, f.default) for f in JConfig.__dataclass_fields__.values()]
    tf = [(f.name, f.default) for f in PortConfig.__dataclass_fields__.values()]
    assert jf == tf
    # The model configs the served path reads, field for field.
    from repro.config import ModelConfig as JModel
    from repro_torch.config import ModelConfig as PortModel

    assert ([(f.name, f.default) for f in JModel.__dataclass_fields__.values()]
            == [(f.name, f.default) for f in PortModel.__dataclass_fields__.values()])


def test_pack_unpack_roundtrip_and_layout():
    tree = {k: v for k, v in from_jax_tree(planted_tree(0, 5)).items()}
    buckets, spec = pack(tree)
    assert sorted(buckets) == [(64, 5, "float32"), (128, 5, "float32")]
    assert spec.bucket_dims[(64, 5, "float32")] == (9, 64)  # 4 A + 4 B + head
    means = {k: b.data.mean(-1) for k, b in buckets.items()}
    out = unpack(spec, means)
    want = tree_map(lambda x: x.mean(0), tree)
    for g, w in zip(tree_leaves(out), tree_leaves(want)):
        assert torch.equal(g, w)
    # Padded rows of every bucket are exactly zero.
    b64 = buckets[(64, 5, "float32")]
    for i, d in enumerate(b64.dims):
        assert torch.all(b64.data[i, d:] == 0)


def test_pack_cohort_padding_masks_new_slots():
    tree = from_jax_tree(planted_tree(1, 5))
    buckets, spec = pack(tree, cohort_size=8)
    assert spec.n_clients == 5 and spec.cohort_size == 8
    for b in buckets.values():
        assert b.data.shape[-1] == 8 and torch.all(b.data[..., 5:] == 0)
        assert b.client_mask.tolist() == [1.0] * 5 + [0.0] * 3


def test_convert_round_trip_is_exact():
    tree = planted_tree(2, 3)
    tree["ints"] = np.arange(6, dtype=np.int32).reshape(2, 3)
    back = to_numpy_tree(from_jax_tree(jax.tree_util.tree_map(jnp.asarray, tree)))
    for g, w in zip(jax.tree_util.tree_leaves(back), jax.tree_util.tree_leaves(tree)):
        assert g.dtype == w.dtype and np.array_equal(g, w)


VARIANTS = ["dense", "masked", "weighted"]


def _inputs(variant, nc=8):
    tree = planted_tree(3, nc)
    mask = weights = None
    if variant in ("masked", "weighted"):
        mask = (np.arange(nc) < nc - 2).astype(np.float32)
        for leaf in jax.tree_util.tree_leaves(tree):
            leaf[nc - 2:] = 0.0
    if variant == "weighted":
        weights = np.linspace(1.0, 3.0, nc).astype(np.float32)
    return tree, mask, weights


# dare draws its own keep masks; its parity cases inject the reference's
# (tests/test_torch_methods.py).
CASES = (
    [(m, {}, v) for m in METHODS if m not in ("fedrpca", "dare") for v in VARIANTS]
    + [("fedrpca", dict(svt_mode=s), v) for s in ("gram", "subspace") for v in VARIANTS]
    + [("fedrpca", dict(joint_ab=True), "dense"), ("fedrpca", dict(joint_ab=True), "masked"),
       ("fedrpca", dict(weighting="data_size_rpca"), "weighted"),
       ("fedrpca", dict(rpca_fixed_iters=False, rpca_tol=1e-3), "masked")]
)


@functools.lru_cache(maxsize=None)
def jax_update(method, extra, variant):
    """The reference's packed-engine update (its packed == reference parity
    is pinned in tests/test_engine.py), computed once per case for both of
    the port's engines."""
    tree, mask, weights = _inputs(variant)
    out = jaggregate(
        jax.tree_util.tree_map(jnp.asarray, tree),
        JConfig(method=method, rpca_iters=10, **dict(extra)),
        mask=None if mask is None else jnp.asarray(mask),
        weights=None if weights is None else jnp.asarray(weights),
    )
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]


@pytest.mark.parametrize("engine", ["packed", "reference"])
@pytest.mark.parametrize("method,extra,variant", CASES, ids=lambda v: str(v))
def test_aggregate_matches_jax(method, extra, variant, engine):
    tree, mask, weights = _inputs(variant)
    kw = dict(method=method, rpca_iters=10, **extra)
    want = jax_update(method, tuple(sorted(extra.items())), variant)
    got = aggregate(
        from_jax_tree(tree), AggregatorConfig(**kw), engine=engine,
        mask=None if mask is None else torch.from_numpy(mask),
        weights=None if weights is None else torch.from_numpy(weights), device="cpu",
    )
    scale = max(np.abs(x).max() for x in jax.tree_util.tree_leaves(tree))
    assert_tree_close(got, want, scale)


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
@pytest.mark.parametrize("variant", VARIANTS)
def test_packed_equals_reference_in_port(svt_mode, variant):
    tree, mask, weights = _inputs(variant)
    cfg = AggregatorConfig(method="fedrpca", rpca_iters=10, svt_mode=svt_mode)
    kw = dict(
        mask=None if mask is None else torch.from_numpy(mask),
        weights=None if weights is None else torch.from_numpy(weights),
        with_diagnostics=True, device="cpu",
    )
    p, pd = aggregate(from_jax_tree(tree), cfg, engine="packed", **kw)
    r, rd = aggregate(from_jax_tree(tree), cfg, engine="reference", **kw)
    scale = max(np.abs(x).max() for x in jax.tree_util.tree_leaves(tree))
    assert_tree_close(p, to_numpy_tree(r), scale)
    sp, sr = rpca_diag_summary(pd), rpca_diag_summary(rd)
    assert sp.keys() == sr.keys()
    for k in sp:
        np.testing.assert_allclose(float(sp[k]), float(sr[k]), rtol=1e-3)


def test_guard_weights_match_jax():
    tree, mask, _ = _inputs("masked")
    for leaf in jax.tree_util.tree_leaves(tree):
        leaf[1] *= 30.0  # one poisoned client
    kw = dict(method="fedrpca", rpca_iters=10, guard_energy_k=3.0)
    want, wd = jaggregate(jax.tree_util.tree_map(jnp.asarray, tree), JConfig(**kw),
                          mask=jnp.asarray(mask), with_diagnostics=True)
    got, gd = aggregate(from_jax_tree(tree), AggregatorConfig(**kw),
                        mask=torch.from_numpy(mask), with_diagnostics=True, device="cpu")
    scale = max(np.abs(x).max() for x in jax.tree_util.tree_leaves(tree))
    assert_tree_close(got, want, scale)
    np.testing.assert_array_equal(
        rpca_diag_summary(gd)["guard_flagged"].numpy(),
        np.asarray(jsummary(wd)["guard_flagged"]),
    )


@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_aggregate_needs_an_explicit_cpu(monkeypatch, engine):
    """Without CUDA the default device raises instead of aggregating on
    the CPU, even for a tree that already lies there."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    tree = from_jax_tree(planted_tree(4, 3), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        aggregate(tree, AggregatorConfig(method="fedrpca", rpca_iters=2), engine=engine)
