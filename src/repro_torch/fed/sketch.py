"""Subspace-sketch compressed uplinks (port of ``repro/fed/sketch.py``).

The server's warm RPCA carry estimates the subspace the client LoRA deltas
share (``BucketCarry.v``, the carried client-side eigenbasis, with the
converged low-rank iterate ``BucketCarry.l``).  A client projects its delta
onto the broadcast basis and ships, per (module, client) column,

    ``(coefficients (r,), sparse residual (top-k values + indices))``

— ``r + 2k`` numbers instead of ``d1``.  The codec works on the packed
``(B, padded_vec, n_clients)`` bucket tensors the engine aggregates, so the
decode writes straight into the layout ``robust_pca_bucket`` consumes.

* **Exact at full coverage.**  The shipped values are the RAW delta entries
  at the top-|residual| positions, and the decode scatter *sets* them
  (``scatter_``), so ``k == d1`` gives the input back bit for bit.
* **Dense-fallback gate.**  ``Sketch.energy_frac`` is the delta energy the
  sketch drops, relative to the delta's own.  Cold rounds (zero basis) and
  basis-drift rounds score high; the engine then selects the dense columns
  with ``torch.where``, bitwise the dense round.
* **Masked columns stay zero** through the codec.

Top-k is a stable descending sort, so tied magnitudes go to the lower index
as ``jax.lax.top_k`` breaks them.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.core import rpca as rpca_lib

#: Bytes per float32 / int32 element of the uplink wire format.
_BYTES_F32 = 4
_BYTES_I32 = 4

#: Default residual budget per (module, client) column.
DEFAULT_K = 64

#: Default dense-fallback gate: the largest fraction of a bucket's delta
#: energy the sketch may drop before the round degrades to dense.
DEFAULT_ENERGY_TOL = 0.3

UPLINK_MODES = ("dense", "sketch")


class UplinkConfig(NamedTuple):
    """Uplink codec configuration (part of the aggregation plan).

    ``mode="dense"`` is the identity uplink: the engine never enters the
    codec.  ``mode="sketch"`` encodes each client column as ``r`` basis
    coefficients plus a ``k``-entry sparse residual, gated per bucket tier
    by ``energy_tol``.
    """

    mode: str = "dense"
    k: int = DEFAULT_K
    energy_tol: float = DEFAULT_ENERGY_TOL

    @property
    def active(self) -> bool:
        return self.mode == "sketch"


def parse_uplink(spec) -> UplinkConfig:
    """Parse an ``--uplink`` spec: ``"dense"``, ``"sketch"``,
    ``"sketch:<k>"``, ``"sketch:<k>:<energy_tol>"``, an ``UplinkConfig``
    (returned as it is) or ``None`` (dense)."""
    if spec is None:
        return UplinkConfig()
    if isinstance(spec, UplinkConfig):
        return spec
    parts = str(spec).split(":")
    mode = parts[0]
    if mode not in UPLINK_MODES:
        raise ValueError(f"unknown uplink mode: {mode!r} (expected one of {UPLINK_MODES})")
    if mode == "dense":
        if len(parts) > 1:
            raise ValueError(f"dense uplink takes no parameters: {spec!r}")
        return UplinkConfig()
    k = int(parts[1]) if len(parts) > 1 and parts[1] else DEFAULT_K
    if k < 1:
        raise ValueError(f"uplink sketch k must be >= 1, got {k}")
    tol = float(parts[2]) if len(parts) > 2 and parts[2] else DEFAULT_ENERGY_TOL
    if not 0.0 <= tol <= 1.0:
        raise ValueError(f"uplink energy_tol must be in [0, 1], got {tol}")
    if len(parts) > 3:
        raise ValueError(f"malformed uplink spec: {spec!r}")
    return UplinkConfig(mode="sketch", k=k, energy_tol=tol)


class Sketch(NamedTuple):
    """One bucket's encoded uplink payload.

    ``coef`` (B, r, C) float32 basis coefficients; ``vals`` (B, C, k) the
    RAW delta entries at the top-|residual| positions; ``idx`` (B, C, k)
    int64 d1-axis positions of ``vals``; ``energy_frac`` (B,) the fraction
    of each module's delta energy the sketch drops.
    """

    coef: torch.Tensor
    vals: torch.Tensor
    idx: torch.Tensor
    energy_frac: torch.Tensor


def uplink_basis(carry_l: torch.Tensor, carry_v: torch.Tensor) -> torch.Tensor:
    """The broadcast d1-side basis of a bucket's RPCA carry: span(l @ v),
    orthonormalized by the subspace SVT's batched CholeskyQR.  A cold carry
    (``l == 0``) gives a zero basis: projections capture nothing and the
    gate trips."""
    z = carry_l.to(torch.float32) @ carry_v.to(torch.float32)
    return rpca_lib._orthonormalize(z)


def encode_delta(m: torch.Tensor, basis: torch.Tensor, k: int) -> Sketch:
    """Encode a (B, d1, C) bucket against a (B, d1, r) orthonormal basis:
    per (module, client) column, ``r`` projection coefficients and the ``k``
    raw entries with the largest reconstruction residual (``k`` clipped to
    ``d1``)."""
    d1 = m.shape[1]
    m32 = m.to(torch.float32)
    kk = min(int(k), d1)
    coef = basis.mT @ m32  # (B, r, C)
    resid = m32 - basis @ coef
    resid_t = resid.transpose(1, 2)  # (B, C, d1)
    order = torch.sort(resid_t.abs(), dim=-1, descending=True, stable=True)
    top_abs, idx = order.values[..., :kk], order.indices[..., :kk]
    # The raw delta entries at those positions, not the residuals: decode
    # overwrites, so full coverage is exact.
    vals = torch.gather(m32.transpose(1, 2), -1, idx)
    resid_sq = torch.sum(resid_t * resid_t, dim=(1, 2))  # (B,)
    kept_sq = torch.sum(top_abs * top_abs, dim=(1, 2))
    m_sq = torch.sum(m32 * m32, dim=(1, 2))
    # The reference's formula, kept as written: at full k the difference
    # cancels down to an fp32 floor rather than exactly zero.
    energy_frac = torch.clamp_min(resid_sq - kept_sq, 0.0) / torch.clamp_min(m_sq, 1e-12)
    return Sketch(coef=coef, vals=vals, idx=idx, energy_frac=energy_frac)


def decode_into_bucket(sketch: Sketch, basis: torch.Tensor) -> torch.Tensor:
    """Decode a ``Sketch`` into the packed (B, d1, C) layout: basis @ coef,
    with the shipped raw entries written over it (a set, not an add)."""
    approx_t = (basis @ sketch.coef).transpose(1, 2).contiguous()  # (B, C, d1)
    approx_t.scatter_(-1, sketch.idx, sketch.vals)
    return approx_t.transpose(1, 2)


def sketch_bytes_per_client(n_modules: int, r: int, k: int) -> float:
    """Wire bytes one client ships for one bucket under the sketch codec:
    per module, ``r`` f32 coefficients, ``k`` f32 values and ``k`` i32
    indices."""
    return float(n_modules) * (_BYTES_F32 * (r + k) + _BYTES_I32 * k)


def dense_bytes_per_client(true_dims) -> float:
    """Wire bytes one client ships for one bucket dense: the true (unpadded)
    f32 payload."""
    return float(_BYTES_F32) * float(sum(int(d) for d in true_dims))


def basis_bytes(n_modules: int, d1: int, r: int) -> float:
    """Downlink bytes of one bucket's broadcast basis (once per round: the
    basis multicast is shared by every client)."""
    return float(_BYTES_F32) * float(n_modules) * float(d1) * float(r)
