"""Published peaks of the cards the benchmark runs on (NVIDIA's data
sheets, dense rates without sparsity, at the full power limit): device
memory bytes/s and FLOP/s by precision.  A card not listed has no peak, and
every share of a peak is then left out of the result."""
from __future__ import annotations

#: name fragment -> (bytes/s, {precision: FLOP/s}); the first match wins.
PEAKS = (
    ("H100 PCIe", (2.0e12, {"bf16": 756e12, "tf32": 378e12, "fp32": 51e12})),
    ("H100 NVL", (3.9e12, {"bf16": 835e12, "tf32": 418e12, "fp32": 60e12})),
    ("H100", (3.35e12, {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12})),
)


def card_peaks(name: str):
    """(bytes/s, {precision: FLOP/s}) of the card named ``name``, or None."""
    for frag, peaks in PEAKS:
        if frag in name:
            return peaks
    return None
