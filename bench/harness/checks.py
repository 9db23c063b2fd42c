"""The comparison that decides ``correct``: each number against its limit."""
from __future__ import annotations

import math
import sys

import torch


def rel_gap(got: torch.Tensor, want: torch.Tensor) -> float:
    """||got - want|| / ||want|| in float64."""
    w = want.double()
    return float(torch.linalg.vector_norm(got.double().to(w.device) - w)
                 / torch.clamp_min(torch.linalg.vector_norm(w), 1e-300))


def worst_gap(got: list, want: list) -> float:
    """The largest ``rel_gap`` over matched matrices (the worst module)."""
    return max(rel_gap(g, w) for g, w in zip(got, want))


def _leaves(mats: list, columns: bool) -> list:
    """The leaves of a list of matrices: each column (one client's) when
    ``columns``, else each whole matrix, flattened, in float64."""
    if columns:
        return [c for m in mats for c in m.double().T]
    return [m.double().reshape(-1) for m in mats]


def leaf_gaps(got: list, want: list, columns: bool, skip_below: float = 0.0) -> tuple:
    """The worst leaf's (gap of norms, norm of the difference), each over
    the larger of the reference's norm of that leaf and of the median
    leaf.  Leaves whose reference norm is under ``skip_below`` times the
    median are left out."""
    g, w = _leaves(got, columns), _leaves(want, columns)
    gn = torch.stack([torch.linalg.vector_norm(x).cpu() for x in g])
    wn = torch.stack([torch.linalg.vector_norm(x).cpu() for x in w])
    dn = torch.stack([torch.linalg.vector_norm(a.to(b.device) - b).cpu() for a, b in zip(g, w)])
    med = float(torch.median(wn))
    keep = wn >= skip_below * med
    if not bool(keep.any()):
        return 0.0, 0.0
    den = torch.clamp_min(wn, med)
    return (float((torch.abs(gn - wn) / den)[keep].max()), float((dn / den)[keep].max()))


def judge(readings: dict, limits: dict) -> tuple:
    """(correct, {name: {"value", "limit"}}) over the numbers that have a
    limit; a number that is not finite fails."""
    out = {k: {"value": readings[k], "limit": limits[k]} for k in limits}
    ok = all(math.isfinite(v["value"]) and v["value"] <= v["limit"] for v in out.values())
    return ok, out


def print_checks(checks: dict) -> None:
    for k, v in checks.items():
        print(f"check {k} = {v['value']!r} (limit {v['limit']!r})", file=sys.stderr, flush=True)
