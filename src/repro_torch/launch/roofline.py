"""Roofline terms and parameter counts at the card's figures (port of
``repro/launch/roofline.py``).

Three terms per (arch x shape x mesh), all in seconds:

    compute    = flops_per_chip / PEAK_FLOPS
    memory     = bytes_per_chip / HBM_BW
    collective = collective_bytes_per_chip / LINK_BW

The figures are one NVIDIA H100 SXM5 80GB's, from its data sheet: 989e12
dense bf16 FLOP/s on the tensor cores, 3.35e12 B/s of HBM3, and 450e9 B/s
of NVLink 4 in each direction (900 GB/s both ways).  ``chip_smoke.py``'s
``card_peaks`` and ``bf16_peak`` print the same figures for the card it
runs on.  The port emits no HLO: the terms are fed from the analytic cost
model (``launch/costmodel.py``).  ``parse_collectives`` is the reference's
text parser of post-optimization HLO, copied as the pure function it is
(the ring-transfer model per op: all-gather and reduce-scatter move
out_bytes (g-1)/g, all-reduce twice that, all-to-all out_bytes (g-1)/g,
collective-permute out_bytes, with g the replica-group size).
"""
from __future__ import annotations

import re
from dataclasses import dataclass
from typing import Dict

import torch
from torch import nn

# NVIDIA H100 SXM5 80GB (data sheet), per card.
PEAK_FLOPS = 989e12  # dense bf16 FLOP/s (tensor cores)
HBM_BW = 3.35e12  # bytes/s
LINK_BW = 450e9  # bytes/s of NVLink 4, each direction

_DTYPE_BYTES = {
    "pred": 1, "s4": 1, "u4": 1,
    "s8": 1, "u8": 1, "f8e4m3fn": 1, "f8e5m2": 1,
    "s16": 2, "u16": 2, "bf16": 2, "f16": 2,
    "s32": 4, "u32": 4, "f32": 4,
    "s64": 8, "u64": 8, "f64": 8, "c64": 8,
    "c128": 16,
}

# e.g.  %ag = bf16[2,16,128]{2,1,0} all-gather(%x), replica_groups={{0,1},{2,3}}
_SHAPE_RE = re.compile(r"(\w+)\[([\d,]*)\]")
_OP_RE = re.compile(
    r"=\s*(?P<outshape>\(?[\w\[\],{}\s/]*?\)?)\s*"
    r"(?P<op>all-gather-start|all-gather|all-reduce-start|all-reduce|"
    r"reduce-scatter|all-to-all|collective-permute-start|collective-permute)\("
)
_GROUPS_RE = re.compile(r"replica_groups=\{\{([\d,]+)\}")
_GROUPS_IOTA_RE = re.compile(r"replica_groups=\[(\d+),(\d+)\]")


def _shape_bytes(text: str) -> int:
    total = 0
    for dtype, dims in _SHAPE_RE.findall(text):
        if dtype not in _DTYPE_BYTES:
            continue
        n = 1
        for d in dims.split(","):
            if d:
                n *= int(d)
        total += n * _DTYPE_BYTES[dtype]
    return total


@dataclass
class CollectiveStats:
    counts: Dict[str, int]
    bytes_by_op: Dict[str, float]  # ring-model per-chip traffic

    @property
    def total_bytes(self) -> float:
        return sum(self.bytes_by_op.values())


def parse_collectives(hlo_text: str) -> CollectiveStats:
    counts: Dict[str, int] = {}
    byts: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _OP_RE.search(line)
        if not m:
            continue
        op = m.group("op").replace("-start", "")
        out_bytes = _shape_bytes(m.group("outshape"))
        if out_bytes == 0:
            continue
        g = _group_size(line)
        frac = (g - 1) / g if g > 1 else 0.0
        if op == "all-reduce":
            moved = 2.0 * out_bytes * frac
        elif op == "collective-permute":
            moved = float(out_bytes)
        else:  # all-gather, reduce-scatter, all-to-all
            moved = out_bytes * frac
        counts[op] = counts.get(op, 0) + 1
        byts[op] = byts.get(op, 0.0) + moved
    return CollectiveStats(counts=counts, bytes_by_op=byts)


def _group_size(line: str) -> int:
    m = _GROUPS_RE.search(line)
    if m:
        return len(m.group(1).split(","))
    m = _GROUPS_IOTA_RE.search(line)
    if m:  # iota replica groups: [num_groups, group_size]
        return int(m.group(2))
    return 1


def roofline_terms(flops_per_chip: float, bytes_per_chip: float,
                   collective_bytes_per_chip: float, chips: int, *,
                   peak_flops: float = PEAK_FLOPS, hbm_bw: float = HBM_BW,
                   link_bw: float = LINK_BW) -> Dict[str, float]:
    """All inputs are per chip; ``chips`` is kept for the record only.  The
    rates default to the card's."""
    compute = flops_per_chip / peak_flops
    memory = bytes_per_chip / hbm_bw
    collective = collective_bytes_per_chip / link_bw
    dominant = max(
        ("compute", compute), ("memory", memory), ("collective", collective),
        key=lambda kv: kv[1],
    )[0]
    return {
        "compute_s": compute,
        "memory_s": memory,
        "collective_s": collective,
        "dominant": dominant,
    }


def model_flops(cfg, shape, n_params_active: int) -> float:
    """MODEL_FLOPS = 6*N*D (train) or 2*N*D (inference), N = active params."""
    tokens = shape.global_batch * (shape.seq_len if shape.kind != "decode" else 1)
    mult = 6.0 if shape.kind == "train" else 2.0
    return mult * n_params_active * tokens


def _named_leaves(tree, path=()):
    """(names, tensor) of a module's ``named_parameters()`` (names split at
    the dots) or of a tree of tensors (dict keys, sequence indices)."""
    if isinstance(tree, nn.Module):
        for name, p in tree.named_parameters():
            yield tuple(name.split(".")), p
    elif isinstance(tree, torch.Tensor):
        yield path, tree
    elif isinstance(tree, dict):
        for k, v in tree.items():
            yield from _named_leaves(v, (*path, str(k)))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _named_leaves(v, (*path, str(i)))


def count_params(tree) -> int:
    """Elements of every parameter of a module or leaf of a tree (``meta``
    tensors included)."""
    return sum(leaf.numel() for _, leaf in _named_leaves(tree))


def count_active_params(tree, cfg) -> int:
    """MoE: experts count once (top-k / E of expert params active per token)."""
    total = 0
    for names, leaf in _named_leaves(tree):
        n = leaf.numel()
        if cfg.n_experts and "moe" in names and names[-1] in ("gate", "up", "down"):
            n = int(n * max(cfg.top_k, 1) / cfg.n_experts)
        total += n
    return total


__all__ = [
    "HBM_BW", "LINK_BW", "PEAK_FLOPS", "CollectiveStats", "count_active_params",
    "count_params", "model_flops", "parse_collectives", "roofline_terms",
]
