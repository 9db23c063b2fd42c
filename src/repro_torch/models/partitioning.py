"""Sharding rules as data: parameter / batch / cache layouts for a mesh
(port of ``repro/models/partitioning.py``).

A spec is a tuple with one entry per dimension of a tensor: a mesh axis
name, a tuple of axis names, or None (replicated along that dimension).  The
rules are the reference's tensor-parallel layout over the ``model`` axis
(Megatron-style):

  embed (V, D)                  -> vocab-sharded            (model, None)
  attn q/k/v w (D, H*hd)        -> head(out)-sharded        (None, model)
  attn o w (H*hd, D)            -> head(in)-sharded         (model, None)
  ffn gate/up (D, F)            -> hidden-sharded           (None, model)
  ffn down (F, D)               -> hidden-sharded           (model, None)
  moe gate/up/down (E, .., ..)  -> expert-sharded           (model, None, None)
  lora A/B                      -> replicated
  norms / biases / conv / A_log -> replicated

Dims that the axis size does not divide fall back to replication (e.g.
Whisper's 51865 vocab).  The client / data batch axes: stacked-client
tensors shard their leading client axis over ("pod", "data"); plain batches
shard their batch over the same axes.

The port's model keeps one ``Block`` per layer where the reference stacks
the layers of a pattern slot along a leading group axis.  Parameters are
walked by their ``named_parameters()`` names, which follow the reference's
keys (``convert.model_from_jax``), and a parameter of a layer that the
reference stacks is judged with that group axis in front, as the reference
judges it: a stacked bias is then 2-D there and shares its weight's output
sharding, where an unstacked (tail) bias is replicated.  The spec returned
has the port tensor's own dims.

One card executes none of this: ``launch/dryrun.py`` reckons the reference's
production meshes with it (``per_device_bytes``).
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch
from torch import nn

from repro_torch.utils.pytree import tree_map, tree_map_with_path

Tree = Any
Spec = Tuple[Any, ...]

# Keys whose *last* dim is model-sharded (column parallel).
_COL_KEYS = {"q", "k", "v", "gate", "up", "in_proj", "proj_x", "proj_gate", "gate_a", "gate_x"}
# Keys whose second-to-last dim is model-sharded (row parallel).
_ROW_KEYS = {"o", "down", "out_proj"}

POLICIES = ("tp", "tp_fsdp", "dp", "ep_replicated", "moe2d")


def _divisible(dim: int, mesh_axis_size: int) -> bool:
    return dim % mesh_axis_size == 0


def param_pspec(
    names: Tuple[str, ...],
    shape: Tuple[int, ...],
    *,
    model_axis: str = "model",
    model_size: int = 16,
    policy: str = "tp",
    fsdp_axes: Tuple[str, ...] = ("data",),
    fsdp_size: int = 16,
) -> Spec:
    """The spec of one parameter, ``names`` its path and ``shape`` its shape
    (with the reference's group axis in front for a stacked layer).

    Policies:

      tp            Megatron tensor-parallel over ``model`` only (weights
                    replicated across the data axis).
      tp_fsdp       tp + the weight's other big dim sharded over the data
                    axes (ZeRO-3-style).
      dp            fully replicated weights; all parallelism from the batch.
      ep_replicated tp, but MoE expert weights shard d_ff over ``model``
                    instead of the expert axis.
      moe2d         experts over ``model`` and their d_ff over the data axes.
    """
    ndim = len(shape)
    spec = [None] * ndim
    if policy == "dp":
        return tuple(spec)

    def ok(axis_from_end: int) -> bool:
        return ndim >= axis_from_end and _divisible(shape[-axis_from_end], model_size)

    def fsdp_ok(axis_from_end: int) -> bool:
        return (policy == "tp_fsdp" and ndim >= axis_from_end
                and _divisible(shape[-axis_from_end], fsdp_size))

    if "embed" in names and "pos" not in "".join(names):
        if ndim >= 2 and _divisible(shape[-2], model_size):
            spec[-2] = model_axis  # (V, D) vocab-sharded
            if fsdp_ok(1):
                spec[-1] = fsdp_axes
        return tuple(spec)
    if "lm_head" in names:
        if ok(1):
            spec[-1] = model_axis
            if fsdp_ok(2):
                spec[-2] = fsdp_axes
        return tuple(spec)
    if "pos_embed" in names or ndim <= 1:
        return tuple(spec)
    if "A" in names or "B" in names:  # LoRA factors: replicated
        return tuple(spec)
    if "moe" in names:
        if names[-1] in ("gate", "up", "down") and ndim >= 3:
            if policy == "ep_replicated":
                # shard the ffn dim over model instead of the expert axis
                dim = -1 if names[-1] in ("gate", "up") else -2
                if _divisible(shape[dim], model_size):
                    spec[dim] = model_axis
                return tuple(spec)
            if _divisible(shape[-3], model_size):
                spec[-3] = model_axis  # expert axis
                ffn_dim = -1 if names[-1] in ("gate", "up") else -2
                if policy == "moe2d" and _divisible(shape[ffn_dim], fsdp_size):
                    spec[ffn_dim] = fsdp_axes  # 2D: E over model, d_ff over data
                elif fsdp_ok(1):
                    spec[-1] = fsdp_axes
            return tuple(spec)
        return tuple(spec)  # router etc.
    if "conv_w" in names or "norm" in "".join(names):
        return tuple(spec)

    owner = None
    for n in reversed(names):
        if n in _COL_KEYS or n in _ROW_KEYS:
            owner = n
            break
    if owner in _COL_KEYS and ok(1):
        spec[-1] = model_axis
        if fsdp_ok(2):
            spec[-2] = fsdp_axes
    elif owner in _ROW_KEYS and ok(2):
        spec[-2] = model_axis
        if fsdp_ok(1):
            spec[-1] = fsdp_axes
    return tuple(spec)


def stacked_in_reference(name: str, cfg) -> bool:
    """Whether the reference stacks parameter ``name`` of the port's model
    along a group axis: every decoder layer of a whole pattern unit (not
    the tail) and every encoder layer."""
    path = name.split(".")
    if path[:2] == ["encoder", "layers"]:
        return True
    return path[0] == "layers" and int(path[1]) < cfg.n_pattern_groups * len(cfg.layer_pattern)


def param_pspecs(
    model,
    cfg,
    *,
    model_axis: str = "model",
    model_size: int = 16,
    policy: str = "tp",
    fsdp_axes: Tuple[str, ...] = ("data",),
    fsdp_size: int = 16,
) -> Dict[str, Spec]:
    """{name: spec} over ``model.named_parameters()`` (an ``nn.Module``, on
    ``meta`` or any device) or a {name: tensor} dict."""
    items = model.named_parameters() if isinstance(model, nn.Module) else model.items()
    out = {}
    for name, t in items:
        lead = (1,) if stacked_in_reference(name, cfg) else ()
        spec = param_pspec(tuple(name.split(".")), (*lead, *t.shape), model_axis=model_axis,
                           model_size=model_size, policy=policy, fsdp_axes=fsdp_axes,
                           fsdp_size=fsdp_size)
        out[name] = spec[len(lead):]
    return out


def batch_pspecs(batch: Tree, client_axes: Tuple[str, ...], client_size: int = 0) -> Tree:
    """Shard the leading (batch or client) axis of every batch leaf.

    Leaves whose leading dim doesn't divide the client-axis size (e.g. the
    long_500k single-request decode) are replicated.
    """

    def spec(leaf):
        if client_size and leaf.shape[0] % client_size != 0:
            return (None,) * leaf.ndim
        return (client_axes, *([None] * (leaf.ndim - 1)))

    return tree_map(spec, batch)


def cache_pspecs(
    caches: Tree,
    cfg,
    client_axes: Tuple[str, ...],
    *,
    model_axis: str = "model",
    model_size: int = 16,
    client_size: int = 0,
    stacked_groups: bool = True,
) -> Tree:
    """KV caches: batch over data axes; kv-head dim over model when divisible.

    Leaves: ``KVCache`` k / v (G, B, L, n_kv, hd) or states (G, B, ...);
    tail entries lack the G axis.  A batch dim that doesn't divide the
    client-axis size (long_500k B = 1) is replicated.  When the head count
    doesn't divide the model axis, head_dim is sharded instead.
    """

    def spec_for(names, leaf):
        in_groups = "groups" in names
        batch_dim = 1 if in_groups else 0
        spec = [None] * leaf.ndim
        if leaf.ndim > batch_dim and not (
            client_size and leaf.shape[batch_dim] % client_size != 0
        ):
            spec[batch_dim] = client_axes
        is_kv = names[-1] in ("k", "v", "k_q", "v_q")
        if is_kv and leaf.ndim >= 2:
            if _divisible(leaf.shape[-2], model_size):
                spec[-2] = model_axis
            elif _divisible(leaf.shape[-1], model_size):
                spec[-1] = model_axis
        return tuple(spec)

    return tree_map_with_path(spec_for, caches)


def lora_pspecs(lora: Tree) -> Tree:
    """LoRA adapters are replicated over the whole mesh (tiny)."""
    return tree_map(lambda l: (None,) * l.ndim, lora)


def stacked_lora_pspecs(lora: Tree, client_axes: Tuple[str, ...]) -> Tree:
    """Per-client LoRA stacks: leading client axis sharded over client axes."""
    return tree_map(lambda l: (client_axes, *([None] * (l.ndim - 1))), lora)


def padded_cohort(d2: int, shards: int) -> int:
    """Smallest multiple of ``shards`` >= ``d2``: ragged cohorts shard by
    zero-padding the client axis to this size with zero-mask columns."""
    if shards <= 0:
        raise ValueError(f"shards must be positive, got {shards}")
    return shards * (-(-d2 // shards))


def bucket_pspec(client_axes: Tuple[str, ...]) -> Spec:
    """Packed shape-bucket layout ``(modules, padded_vec, cohort)``: client
    columns shard-major over the client mesh axes, everything else
    replicated."""
    return (None, None, client_axes)


def bucket_carry_pspecs(client_axes: Tuple[str, ...]):
    """Specs of one ``rpca.BucketCarry`` under client sharding: the ADMM
    iterates ``l`` / ``s`` / ``y`` shard their client columns like the
    bucket, the basis ``v`` (B, d2, r) its rows (one per client), and the
    scalars are replicated (``()``)."""
    from repro_torch.core import rpca as rpca_lib

    col = bucket_pspec(client_axes)
    rep = ()
    return rpca_lib.BucketCarry(
        l=col, s=col, y=col,
        v=(None, client_axes, None),
        n_live=rep, n_eff=rep, valid=rep, fall_count=rep, hit=rep,
    )


def _axis_size(entry, sizes: Dict[str, int]) -> int:
    if entry is None:
        return 1
    n = 1
    for a in (entry,) if isinstance(entry, str) else entry:
        n *= sizes[a]
    return n


def _pairs(tensors, specs):
    """(tensor, spec) pairs of a module with a {name: spec} dict, or of a
    tree of tensors with the spec tree of the same structure."""
    if isinstance(tensors, nn.Module):
        for name, t in tensors.named_parameters():
            yield t, specs[name]
    elif isinstance(tensors, torch.Tensor):
        yield tensors, specs
    elif isinstance(tensors, dict):
        for k, v in tensors.items():
            yield from _pairs(v, specs[k])
    elif isinstance(tensors, (list, tuple)):
        for v, s in zip(tensors, specs):
            yield from _pairs(v, s)


def per_device_bytes(tensors, specs, mesh) -> int:
    """The bytes one device holds of ``tensors`` laid out by ``specs`` on
    ``mesh`` (a ``config.MeshConfig``): each dim split over the product of
    its axes' sizes, rounded up.  Works on ``meta`` tensors."""
    sizes = dict(zip(mesh.axes, mesh.shape))
    total = 0
    for t, spec in _pairs(tensors, specs):
        n = t.element_size()
        for dim, entry in zip(t.shape, spec):
            k = _axis_size(entry, sizes)
            n *= -(-dim // k)
        total += n
    return total


__all__ = [
    "POLICIES", "batch_pspecs", "bucket_carry_pspecs", "bucket_pspec", "cache_pspecs",
    "lora_pspecs", "padded_cohort", "param_pspec", "param_pspecs", "per_device_bytes",
    "stacked_in_reference", "stacked_lora_pspecs",
]
