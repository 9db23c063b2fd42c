"""The traced tail of a run: ``torch.profiler`` over a few rounds or calls,
spans that the benchmark opens around the program's entries, and the
reductions of the trace that the per-layer metrics read.

A span is a ``record_function`` range opened by a wrapper put in place of
a module attribute for the traced tail only (``Spans.around``); the wrapper
also records the shapes of each call, from which ``bench/work`` reckons the
call's bound.  A range's device time is that of the operations on the card
(kernels, copies, fills) whose launch calls the host made on the range's
thread inside the range: each operation is matched to its launch call by
the profiler's correlation id.  This holds for kernels launched through
``ctypes`` with no PyTorch op around them, which the profiler links to no
op.  Nested ranges of one name are merged first, so nothing counts twice.
"""
from __future__ import annotations

import contextlib
import functools
import time
from collections import defaultdict

import numpy as np
import torch

#: Captures taken before an empty device trace is given up (the profiler
#: now and then returns none on this card).
TRIES = 3
#: Host ops whose device time the readers take, besides the spans.
OPS = ("aten::linalg_eigh",)


class Spans:
    """Wrappers that open a named range around a module attribute and keep
    the shapes of every call."""

    def __init__(self):
        self.calls: dict = defaultdict(list)
        self.names: set = set()

    @contextlib.contextmanager
    def around(self, module, attr: str, name: str, shapes):
        orig = getattr(module, attr)
        calls = self.calls[name]
        self.names.add(name)

        def wrapper(*args, **kw):
            with torch.profiler.record_function(name):
                calls.append(shapes(*args, **kw))
                return orig(*args, **kw)

        # A kernel entry counts its launches on its own function object
        # (``f.launches += 1`` through the module's name): the wrapper
        # carries those attributes while it stands in, and hands them back.
        functools.update_wrapper(wrapper, orig)
        setattr(module, attr, wrapper)
        try:
            yield
        finally:
            setattr(module, attr, orig)
            for k, v in vars(wrapper).items():
                if k != "__wrapped__":
                    setattr(orig, k, v)


class Event:
    """One profiler event, as the reductions read it (times in ns)."""

    __slots__ = ("name", "device", "start", "end", "corr", "thread", "annotation")

    def __init__(self, name, device, start, end, corr, thread, annotation=False):
        self.name, self.device, self.start, self.end = name, device, start, end
        self.corr, self.thread, self.annotation = corr, thread, annotation


def _call(e, name: str, default):
    """``e.name()`` where this PyTorch's event has the method (the API
    differs between versions), else ``default``."""
    f = getattr(e, name, None)
    return f() if f is not None else default


def _events(prof) -> list:
    from torch.autograd import DeviceType

    out = []
    for e in prof.profiler.kineto_results.events():
        start = e.start_ns()
        out.append(Event(e.name(), e.device_type() != DeviceType.CPU, start,
                         start + e.duration_ns(), e.correlation_id(), e.start_thread_id(),
                         bool(_call(e, "is_user_annotation", False))
                         or "annotation" in str(_call(e, "activity_type", ""))))
    return out


def capture(fn, span_names=()):
    """Run ``fn`` under the profiler (a synchronise on either side) and
    reduce its trace: a dict, or None when every capture came back without
    device time."""
    from torch.profiler import ProfilerActivity, profile

    for _ in range(TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            window = time.perf_counter() - t0
        red = reduce_trace(_events(prof), window, span_names)
        if red is not None:
            return red
    return None


def _merge(iv: list) -> list:
    """Sorted disjoint intervals covering ``iv``."""
    out = []
    for s, e in sorted(iv):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def reduce_trace(events: list, window: float, span_names=()):
    """Busy time, the device operations by name, the device time under each
    span and each op of ``OPS``, and the idle gaps by what the host was in;
    None without device operations."""
    dev = [e for e in events if e.device and not e.annotation and e.end > e.start
           and e.name not in span_names]
    if not dev:
        return None
    host = [e for e in events if not e.device]
    dur_by_corr = defaultdict(float)
    for e in dev:
        dur_by_corr[e.corr] += (e.end - e.start) / 1e9
    launches = [e for e in host if e.name.startswith("cu") and e.corr in dur_by_corr]
    by_thread = defaultdict(list)
    for e in launches:
        by_thread[e.thread].append((e.start, dur_by_corr[e.corr]))
    for v in by_thread.values():
        v.sort()
    starts = {t: np.array([x[0] for x in v]) for t, v in by_thread.items()}
    csum = {t: np.concatenate([[0.0], np.cumsum([x[1] for x in v])])
            for t, v in by_thread.items()}

    def under(name: str) -> dict:
        ranges = [e for e in host if e.name == name]
        total = 0.0
        per_thread = defaultdict(list)
        for e in ranges:
            per_thread[e.thread].append((e.start, e.end))
        for t, iv in per_thread.items():
            if t not in starts:
                continue
            for s, e in _merge(iv):
                i, j = np.searchsorted(starts[t], [s, e], side="left")
                total += csum[t][j] - csum[t][i]
        return {"calls": len(ranges), "device_s": total}

    busy, gaps = 0.0, []
    merged = _merge([(e.start, e.end) for e in dev])
    for k, (s, e) in enumerate(merged):
        busy += (e - s) / 1e9
        if k:
            gaps.append((merged[k - 1][1], s))
    by_name = defaultdict(float)
    for e in dev:
        by_name[e.name[:80]] += (e.end - e.start) / 1e9
    return {
        "window_s": window,
        "busy_s": min(busy, window),
        "device_total_s": sum(by_name.values()),
        "device_ops": sorted(by_name.items(), key=lambda kv: -kv[1]),
        "spans": {n: under(n) for n in span_names},
        "ops": {n: under(n)["device_s"] for n in OPS},
        "idle_gaps": _label_gaps(gaps, host),
    }


def _label_gaps(gaps, host, keep: int = 200) -> list:
    """The longest idle gaps, summed by the innermost benchmark span and the
    innermost other host event that the host was inside at a gap's middle."""
    if not gaps:
        return []
    g = np.array(gaps, dtype=np.float64)
    g = g[np.argsort(g[:, 0] - g[:, 1])][:keep]
    st = np.array([e.start for e in host], dtype=np.float64)
    en = np.array([e.end for e in host], dtype=np.float64)
    bench = np.array([e.name.startswith("bench.") for e in host])
    total = defaultdict(float)
    for s, e in g:
        mid = 0.5 * (s + e)
        inside = (st <= mid) & (en >= mid)
        label = []
        for sel in (inside & bench, inside & ~bench):
            idx = np.nonzero(sel)[0]
            if len(idx):
                label.append(host[idx[np.argmin(en[idx] - st[idx])]].name[:60])
        total[" > ".join(label) or "(host outside any event)"] += (e - s) / 1e9
    return sorted(total.items(), key=lambda kv: -kv[1])


@contextlib.contextmanager
def span(name: str):
    """A benchmark range around a phase of the run (a no-op outside a
    profile)."""
    with torch.profiler.record_function(name):
        yield
