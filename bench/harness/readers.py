"""Reductions shared by the per-layer metric readers.  Each returns None
where the run recorded nothing to read (no trace, no call under a span,
no peak for the card), and the metric is then left out of the result."""
from __future__ import annotations

from bench.work import counts

#: Span -> (work of one call from its recorded shapes, peak precision).
WORK = {
    "bench.lora": (lambda m, k, n, r, slots: counts.lora_call(m, k, n, r, slots), "bf16"),
    "bench.attention": (lambda bh, bh_kv, s, d, causal, window:
                        counts.attention_call(bh, bh_kv, s, d, causal, window), "bf16"),
    "bench.subspace": (lambda b, vec, d2: counts.subspace_apply_call(b, vec, d2), "tf32"),
}


def roofline(record: dict, span: str):
    """Percent of the card's roofline: the calls' summed bound over the
    device time of the kernels launched under ``span``."""
    tr, peaks = record.get("trace"), record.get("peaks")
    shapes = record.get("calls", {}).get(span, [])
    if tr is None or peaks is None or not shapes:
        return None
    dev = tr["spans"].get(span, {}).get("device_s", 0.0)
    if not dev:
        return None
    work, prec = WORK[span]
    bw, flops = peaks
    bound = sum(counts.bound_s(*work(*c), flops[prec], bw) for c in shapes)
    return 100.0 * bound / dev


def idle_share(record: dict):
    """Percent of the traced window in which no operation ran on the card."""
    tr = record.get("trace")
    if tr is None or tr["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - tr["busy_s"] / tr["window_s"])


def mean(xs):
    return sum(xs) / len(xs) if xs else None
