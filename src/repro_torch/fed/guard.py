"""Pre-aggregation update quarantine.

Port of ``repro/fed/guard.py``.  ``screen`` gates one round's stacked
client deltas before aggregation: it folds non-finite clients and norm
outliers into the validity mask and *zeroes* quarantined columns so no
non-finite value can reach an aggregator.  The zeroing is a
``torch.where`` select, not a mask multiply: ``pack`` zeroes masked
columns by multiplication, and ``NaN * 0 == NaN``.

The screen is layer one of the quarantine; layer two is the RPCA
sparse-energy score (``AggregatorConfig.guard_energy_k``, inside both
engines), which catches finite, norm-plausible poison (sign flips) that no
per-column statistic can see.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

_EPS = 1e-12


@dataclasses.dataclass(frozen=True)
class GuardConfig:
    """Quarantine thresholds.

    ``norm_k`` is the robust z-score cutoff on per-client log delta norms
    (median absolute deviation units); ``norm_ratio_min`` floors the cutoff
    at ``log(norm_ratio_min)`` so homogeneous cohorts (MAD ~ 0) don't flag
    benign spread.  ``energy_k`` feeds ``AggregatorConfig.guard_energy_k``
    (0 disables the energy layer).
    """

    norm_k: float = 6.0
    norm_ratio_min: float = 4.0
    energy_k: float = 3.0

    def replace(self, **kw) -> "GuardConfig":
        return dataclasses.replace(self, **kw)


def _client_sq_norms(deltas) -> torch.Tensor:
    """(cohort,) per-client squared norms summed over every leaf (float32)."""
    total = 0.0
    for leaf in tree_leaves(deltas):
        x = leaf.to(torch.float32)
        total = total + torch.sum(torch.square(x).reshape(x.shape[0], -1), dim=1)
    return total


def _client_finite(deltas) -> torch.Tensor:
    """(cohort,) bool: every element of every leaf of the client is finite."""
    ok = None
    for leaf in tree_leaves(deltas):
        f = torch.isfinite(leaf).reshape(leaf.shape[0], -1).all(dim=1)
        ok = f if ok is None else ok & f
    return ok


def _zero_columns(deltas, keep: torch.Tensor):
    def zero(x):
        k = keep.reshape((keep.shape[0],) + (1,) * (x.ndim - 1))
        return torch.where(k, x, torch.zeros_like(x))

    return tree_map(zero, deltas)


def _nanmedian(x: torch.Tensor) -> torch.Tensor:
    # jnp.nanmedian averages the two middle values; torch.nanmedian returns
    # the lower one.  nanquantile(0.5) interpolates as the reference does.
    return torch.nanquantile(x, 0.5)


def screen(deltas, mask, cfg: GuardConfig):
    """Quarantine non-finite and norm-outlier clients before aggregation.

    ``deltas`` are the stacked per-slot client deltas (leading axis =
    cohort); ``mask`` the (cohort,) float32 validity mask (all-ones for full
    participation).  Returns ``(cleaned, new_mask, diags)``: quarantined
    columns are zeroed by a where-select and folded out of the mask;
    ``diags`` carries ``guard_nonfinite`` / ``guard_norm_outliers`` /
    ``guard_quarantined`` counts, the per-client ``flags`` vector, and
    ``screen_clean`` (1.0 iff the cleaned tree is fully finite — the
    zero-escapes invariant, which must always hold).  Every value stays on
    the device: the screen reads nothing on the host.
    """
    mask = torch.as_tensor(mask, dtype=torch.float32, device=tree_leaves(deltas)[0].device)
    valid0 = mask > 0
    finite = _client_finite(deltas)
    keep = valid0 & finite

    # Sanitize first: every column not kept becomes exactly zero, so the
    # norm statistics below see no non-finite value at all.
    cleaned = _zero_columns(deltas, keep)

    # Robust norm outlier test on the surviving clients: |log n - med| >
    # max(norm_k * 1.4826 * MAD, log(norm_ratio_min)).
    logn = 0.5 * torch.log(_client_sq_norms(cleaned) + _EPS)
    vals = torch.where(keep, logn, torch.full_like(logn, float("nan")))
    med = _nanmedian(vals)
    mad = _nanmedian(torch.abs(vals - med))
    cut = torch.clamp_min(cfg.norm_k * 1.4826 * mad, math.log(cfg.norm_ratio_min))
    outlier = keep & (torch.abs(logn - med) > cut)

    final = keep & ~outlier
    cleaned = _zero_columns(deltas, final)
    new_mask = mask * final.to(torch.float32)
    flags = (valid0 & ~final).to(torch.float32)
    diags = {
        "guard_nonfinite": torch.sum((valid0 & ~finite).to(torch.float32)),
        "guard_norm_outliers": torch.sum(outlier.to(torch.float32)),
        "guard_quarantined": torch.sum(flags),
        "flags": flags,
        "screen_clean": torch.stack(
            [torch.isfinite(leaf).all() for leaf in tree_leaves(cleaned)]
        ).all().to(torch.float32),
    }
    return cleaned, new_mask, diags
