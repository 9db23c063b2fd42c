"""Spans and counters inside the port, on exactly while a PyTorch profiler
records (``torch.profiler.profile``; the check ``record_function`` makes).

    with trace.span("repro.engine.pack"):
        ...
    trace.count("rpca.exact.cold")
    if trace.host_read(torch.any(err > tol), "admm_tol"):
        ...

Off, ``span`` is one check and a shared null context, ``count`` one check,
and ``host_read`` the bare conversion: nothing is recorded, no CUDA event
is made and no autograd hook is registered.

On, a span opens a profiler range of its name (``record_function``'s range,
through its C++ entry where this PyTorch has one), so it lies on the
profiler's timeline beside the device operations its launches made, and
keeps a record in a bounded in-memory buffer: its name, start and end on
the profiler's clock (``time.time_ns``, which kineto's ``start_ns`` also
reads), its parent span (per thread), the ids of its round (``repro.round``)
and aggregation call (``repro.agg.call``), and, once CUDA is in use, a CUDA
event pair on the current stream.  The events are read in ``summary`` only,
never on the hot path.

``host_read`` is the one way the round and aggregation paths turn a device
value into a Python value; it counts ``host_syncs`` and ``sync.<why>``.
``to_device`` and ``sync`` count the other host syncs of those paths: a copy
from host memory to a card, which waits for the stream, ``eigh``'s read of
its info on a card, and a wait on the stream.  ``summary`` gives, per span
name, calls, host and self host seconds and device ms, the counters, and
the rounds and calls recorded, by which readers normalise.
"""
from __future__ import annotations

import collections
import contextlib
import functools
import itertools
import threading
import time

import torch

#: Records kept; older ones are dropped first (``summary``'s ``dropped``).
MAX_RECORDS = 1 << 16
#: Span names that number a scope: a record carries the id of the innermost
#: enclosing span of each (or, on a thread with none open, the latest).
SCOPES = {"repro.round": "round", "repro.agg.call": "call"}

enabled = torch._C._autograd._profiler_enabled
_range = getattr(torch._C._profiler, "_RecordFunctionFast", None) or torch.profiler.record_function
_NULL = contextlib.nullcontext()


class _State:
    """Everything a trace holds; ``reset`` starts a new one."""

    def __init__(self):
        self.records: collections.deque = collections.deque(maxlen=MAX_RECORDS)
        self.dropped = 0
        self.counters: collections.Counter = collections.Counter()
        self.lock = threading.Lock()
        self.seq = itertools.count()
        self.latest = {"round": None, "call": None}
        self.local = threading.local()


_S = _State()


def reset() -> None:
    """Drop every record and counter."""
    global _S
    _S = _State()


class _Record:
    __slots__ = ("name", "seq", "up", "parent", "round", "call", "start_ns", "end_ns",
                 "events", "child_ns", "rng")

    def __init__(self, name: str):
        st = _S
        stack = _stack()
        top = self.up = stack[-1] if stack else None
        self.name, self.seq = name, next(st.seq)
        self.parent = None if top is None else top.seq
        self.round = st.latest["round"] if top is None else top.round
        self.call = st.latest["call"] if top is None else top.call
        scope = SCOPES.get(name)
        if scope is not None:
            setattr(self, scope, self.seq)
            st.latest[scope] = self.seq
        self.child_ns = 0
        self.end_ns = None
        self.events = None
        self.rng = _range(name)
        self.rng.__enter__()
        if torch.cuda.is_initialized():
            self.events = (torch.cuda.Event(enable_timing=True),
                           torch.cuda.Event(enable_timing=True))
            self.events[0].record()
        stack.append(self)
        self.start_ns = time.time_ns()

    def close(self) -> None:
        self.end_ns = time.time_ns()
        if self.events is not None:
            self.events[1].record()
        self.rng.__exit__(None, None, None)
        self.rng = None
        stack = _stack()
        if self in stack:
            stack.remove(self)
        if self.up is not None:
            self.up.child_ns += self.end_ns - self.start_ns
            self.up = None
        st = _S
        if len(st.records) == MAX_RECORDS:
            st.dropped += 1
        st.records.append(self)


def _stack() -> list:
    loc = _S.local
    if not hasattr(loc, "stack"):
        loc.stack = []
    return loc.stack


class _Span:
    __slots__ = ("name", "rec")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.rec = _Record(self.name)
        return self.rec

    def __exit__(self, *exc):
        self.rec.close()
        return False


def span(name: str):
    """A context manager: the span ``name`` while tracing, else a shared
    null context."""
    if not enabled():
        return _NULL
    return _Span(name)


def traced(name: str):
    """Decorator: the whole function as the span ``name``."""

    def wrap(fn):
        @functools.wraps(fn)
        def inner(*args, **kw):
            with span(name):
                return fn(*args, **kw)

        return inner

    return wrap


def backward_span(name: str, first: torch.Tensor, last: torch.Tensor) -> None:
    """While tracing, the span ``name`` over the backward of the operations
    from ``first``'s to ``last``'s (each the output of one): opened by a
    pre-hook on ``last``'s autograd node, closed by a hook on ``first``'s.
    The hooks return nothing, so the gradients are those of an untraced
    call.  Nothing is registered when tracing is off or either tensor has
    no autograd node."""
    if not enabled() or first.grad_fn is None or last.grad_fn is None:
        return
    box = []

    def open_(grads):
        if enabled():
            box.append(_Record(name))

    def close(grad_inputs, grad_outputs):
        if box:
            box.pop().close()

    last.grad_fn.register_prehook(open_)
    first.grad_fn.register_hook(close)


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the counter ``name`` while tracing."""
    if enabled():
        with _S.lock:
            _S.counters[name] += n


def sync(why: str, device, n: int = 1) -> None:
    """Count ``n`` host syncs under ``sync.<why>`` that no Python conversion
    makes (``eigh``'s read of its info, a wait on the stream), where
    ``device`` is a card: on the CPU they wait for nothing."""
    if enabled() and torch.device(device).type == "cuda":
        with _S.lock:
            _S.counters["host_syncs"] += n
            _S.counters["sync." + why] += n


def host_read(x, why: str, cast=bool):
    """``cast(x)``, the host's read of the value ``x``; a tensor read counts
    one host sync under ``sync.<why>`` while tracing."""
    if isinstance(x, torch.Tensor) and enabled():
        with _S.lock:
            _S.counters["host_syncs"] += 1
            _S.counters["sync." + why] += 1
    return cast(x)


def to_device(x, why: str, device, dtype=None) -> torch.Tensor:
    """``torch.as_tensor(x, dtype=dtype, device=device)``, counting the host
    sync of a copy from host memory to a card under ``sync.<why>``."""
    device = torch.device(device)
    if not (isinstance(x, torch.Tensor) and x.device.type == "cuda"):
        sync(why, device)
    return torch.as_tensor(x, dtype=dtype, device=device)


def summary() -> dict:
    """What the trace holds: ``spans`` {name: {calls, host_s, self_s,
    device_ms}} over the closed records (``device_ms`` None without CUDA
    events), ``counters``, the ``rounds`` and ``calls`` recorded (closed
    ``repro.round`` and ``repro.agg.call`` spans) and the records
    ``dropped`` from the bounded buffer.  Waits for the card to read the
    events."""
    st = _S
    recs = list(st.records)
    if any(r.events is not None for r in recs):
        torch.cuda.synchronize()
    spans: dict = {}
    for r in recs:
        s = spans.setdefault(r.name, {"calls": 0, "host_s": 0.0, "self_s": 0.0,
                                      "device_ms": None})
        dur = r.end_ns - r.start_ns
        s["calls"] += 1
        s["host_s"] += dur / 1e9
        s["self_s"] += (dur - r.child_ns) / 1e9
        if r.events is not None:
            s["device_ms"] = (s["device_ms"] or 0.0) + r.events[0].elapsed_time(r.events[1])
    with st.lock:
        counters = dict(st.counters)
    return {"spans": spans, "counters": counters,
            "rounds": spans.get("repro.round", {}).get("calls", 0),
            "calls": spans.get("repro.agg.call", {}).get("calls", 0),
            "dropped": st.dropped}


def records() -> list:
    """The closed records, oldest first: dicts of name, seq, parent, round,
    call, start_ns and end_ns."""
    return [{k: getattr(r, k) for k in ("name", "seq", "parent", "round", "call", "start_ns",
                                        "end_ns")} for r in list(_S.records)]
