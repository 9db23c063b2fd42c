"""The trace reductions on a made-up trace: spans take the device time of
the launches inside them, nested ranges count once, idle gaps are named by
what the host was in."""
from __future__ import annotations

from bench.harness import trace
from bench.harness.trace import Event


def _trace():
    us = 1000
    return [
        # host: a benchmark span around an op that launches two kernels,
        # and a nested pair of eigh ranges around a third launch
        Event("bench.subspace", False, 0, 100 * us, 1, 7, annotation=True),
        Event("cudaLaunchKernel", False, 10 * us, 11 * us, 501, 7),
        Event("cuLaunchKernelEx", False, 20 * us, 21 * us, 502, 7),
        Event("aten::linalg_eigh", False, 100 * us, 300 * us, 9, 7),
        Event("aten::linalg_eigh", False, 210 * us, 290 * us, 10, 7),
        Event("cudaLaunchKernel", False, 220 * us, 221 * us, 503, 7),
        Event("aten::copy_", False, 400 * us, 900 * us, 11, 7),
        # device: the three kernels, and the span's own device row
        Event("k1", True, 15 * us, 45 * us, 501, 0),
        Event("k2", True, 45 * us, 65 * us, 502, 0),
        Event("syevj", True, 230 * us, 330 * us, 503, 0),
        Event("bench.subspace", True, 15 * us, 65 * us, 1, 0, annotation=True),
    ]


def test_spans_ops_busy_and_gaps():
    red = trace.reduce_trace(_trace(), 1e-3, ("bench.subspace",))
    assert abs(red["spans"]["bench.subspace"]["device_s"] - 50e-6) < 1e-12
    assert red["spans"]["bench.subspace"]["calls"] == 1
    assert abs(red["ops"]["aten::linalg_eigh"] - 100e-6) < 1e-12
    assert abs(red["busy_s"] - 150e-6) < 1e-12
    assert abs(red["device_total_s"] - 150e-6) < 1e-12
    assert red["device_ops"][0][0] == "syevj"
    (label, secs), = red["idle_gaps"]
    assert label == "aten::linalg_eigh" and abs(secs - 165e-6) < 1e-12


def test_no_device_time_is_none():
    assert trace.reduce_trace([e for e in _trace() if not e.device], 1e-3) is None
