"""Async buffered round pipeline.

Port of ``repro/fed/pipeline.py``.  A round's aggregation does not read
anything the next round's local phase writes, so the two can overlap:

    dispatch local_r            (reads the global missing the last s updates)
    land    agg_{r-s}           (apply the oldest in-flight update)
    dispatch agg_r              (chained on the previous dispatch's carry)

``staleness`` bounds the number of in-flight aggregation dispatches (a
FedBuff-style K-deep buffer).  ``staleness=0`` lands every update before
the next local phase: the synchronous schedule, bit for bit, inline on the
calling thread and its current CUDA stream.  The aggregation phase returns
the *scaled update*; ``run_rounds`` adds it to the global at land time
(``phases.apply``), so K in-flight updates land in dispatch order.

With ``staleness > 0`` the dispatches run on one ``AggWorker`` thread, and
on CUDA on a side stream that the worker makes current.  Both are needed:
the ADMM loop reads values on the host (the carry gate once a call, subspace
mode's gates once an iteration), and a read blocks the thread that issued
it.  The kernels launch on PyTorch's current stream, so they follow the
worker's.  The cross-stream hazards are fenced by events: each dispatch
records one on the calling stream after the local phase, and the side
stream waits on it before it reads the bundle; the worker records an event
and synchronizes its stream before it returns; at landing the calling
stream waits on that event before ``apply``, and every landed update
tensor is ``record_stream``-ed on the calling stream, so the caching
allocator does not hand its memory to the side stream while ``apply``
still reads it.

Landing is also where the fault supervisor lives: a non-finite aggregation
output (``update_finite`` read on the host once) never reaches the global —
it is retried once with a bitwise-cold carry, then degraded to plain masked
FedAvg (``phases.fallback``), both with a warning.
"""
from __future__ import annotations

import time
import warnings
from collections import deque
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.utils.pytree import tree_leaves, tree_map

_RES_EPS = 1e-12


def stale_scale(staleness: int) -> float:
    """FedAsync-style polynomial staleness weight 1 / (1 + tau); exactly 1.0
    at tau = 0, so the synchronous path is bit-for-bit unscaled."""
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    return 1.0 / (1.0 + staleness)


class AdaptiveStaleScale:
    """Residual-driven staleness damping.

    Keeps a host-side EMA of the landed ``rpca_residual_max`` and scales
    the tau term by the current-to-typical ratio, clipped to [0.25, 4.0].
    ``tau = 0`` always returns exactly 1.0; before any residual has landed,
    or for methods that report none, it is ``stale_scale``.
    """

    def __init__(self, decay: float = 0.9):
        self.decay = decay
        self.ema: Optional[float] = None
        self.last: Optional[float] = None

    def observe(self, diags: dict) -> None:
        res = diags.get("rpca_residual_max")
        if res is None:
            return
        res = float(res)
        if not (res == res and abs(res) != float("inf")):
            return  # a non-finite residual must not poison the EMA
        self.last = res
        self.ema = res if self.ema is None else (
            self.decay * self.ema + (1.0 - self.decay) * res
        )

    def scale_for(self, tau: int) -> float:
        if tau == 0:
            return 1.0
        if self.ema is None or self.last is None:
            return stale_scale(tau)
        ratio = self.last / max(self.ema, _RES_EPS)
        ratio = min(max(ratio, 0.25), 4.0)
        return 1.0 / (1.0 + tau * ratio)


class InFlightQueue:
    """Bounded FIFO of in-flight dispatches — the staleness bound.

    Updates land in dispatch order; the caller pops *before* dispatching
    (``pop_ready``) and enqueues *after* (``push``).  ``depth=0`` is the
    synchronous schedule: ``pop_ready`` is always None and ``push`` hands
    the item straight back to be landed.  ``drain()`` yields the rest at
    the end of training.
    """

    def __init__(self, depth: int):
        if depth < 0:
            raise ValueError(f"queue depth must be >= 0, got {depth}")
        self.depth = depth
        self._q: deque = deque()

    def __len__(self) -> int:
        return len(self._q)

    def pop_ready(self):
        """Oldest entry when the queue sits at its bound, else None."""
        if self.depth and len(self._q) >= self.depth:
            return self._q.popleft()
        return None

    def push(self, item):
        """Enqueue a fresh dispatch.  Returns the item itself at depth 0
        (land it now), else None."""
        if self.depth == 0:
            return item
        if len(self._q) >= self.depth:
            raise RuntimeError(
                "InFlightQueue full: pop_ready() and land the oldest entry "
                "before dispatching a new one"
            )
        self._q.append(item)
        return None

    def drain(self):
        while self._q:
            yield self._q.popleft()


class AggWorker:
    """One worker thread that runs the aggregation dispatches in order.

    The single-worker FIFO keeps the carry chain ordered (a dispatch that
    reads the previous dispatch's carry future never blocks: its
    predecessor already ran).  ``submit`` returns a
    ``concurrent.futures.Future``; a worker exception surfaces at
    ``result()``, when the round lands.
    """

    def __init__(self):
        self._ex = ThreadPoolExecutor(max_workers=1, thread_name_prefix="agg-phase")

    def submit(self, fn, *args) -> Future:
        return self._ex.submit(fn, *args)

    def close(self):
        self._ex.shutdown(wait=True)


def _default_apply(lora_global, scaled_update):
    """Land-time composition for duck-typed phases without ``apply``."""
    return tree_map(lambda g, su: g + su, lora_global, scaled_update)


def _tensors(tree) -> list:
    return [x for x in tree_leaves(tree) if isinstance(x, torch.Tensor)]


def _cuda_device(tree) -> Optional[torch.device]:
    for x in _tensors(tree):
        if x.is_cuda:
            return x.device
    return None


def _sync(tree) -> None:
    """Wait on the current stream of the tree's card (the reference's
    ``block_until_ready``); nothing on the CPU."""
    dev = _cuda_device(tree)
    if dev is not None:
        torch.cuda.current_stream(dev).synchronize()


class _InFlight(NamedTuple):
    """One dispatched aggregation awaiting landing."""

    round_idx: int
    loss_mean: Any  # the round's local-loss scalar
    out: Any  # (scaled_update, agg_carry', diags), or a Future of (that, event, device)
    bundle: Any  # the round's LocalBundle (kept for supervisor retries)
    scale: Any  # the round's staleness damping (kept for retries)
    t_local: float  # local phase dispatch -> ready, seconds
    t_dispatch: float  # perf_counter timestamp just before the agg dispatch


def run_rounds(
    phases,
    state,
    rounds: int,
    *,
    staleness: int = 0,
    n_active: Optional[int] = None,
    scale: Optional[float] = None,
    on_round: Optional[Callable[[int, Any, dict], None]] = None,
    timers: bool = True,
):
    """Drive ``rounds`` server rounds over split phases with a staleness bound.

    ``phases`` is a ``fed.server.RoundPhases`` (or anything with its
    ``local`` / ``agg`` / ``prep_state`` surface); ``state`` the initial
    ``RoundState``.  ``staleness=0`` lands every aggregation before the next
    local phase — bitwise ``make_round_fn``'s composition.  ``staleness=K>0``
    keeps up to K aggregations in flight on the worker thread (and its CUDA
    stream): each dispatch chains on the *previous dispatch's* carry, and
    the scaled updates land in dispatch order through ``phases.apply``.

    Each landed update is damped by its actual staleness tau (how many
    updates were in flight when its local phase ran): exactly 1.0 at
    tau = 0, else ``AdaptiveStaleScale``; ``scale`` overrides it with a
    constant.

    Landing runs the fault supervisor: when ``update_finite == 0`` the
    aggregation is retried once with ``phases.cold_carry()``, and if still
    non-finite degraded to ``phases.fallback`` (masked FedAvg), each with a
    warning and the ``supervisor_retry`` / ``degraded`` diagnostics.
    Duck-typed phases without those attributes skip the ladder.

    ``on_round(r, state, diags)`` fires once per round, in round order, when
    round r's update has landed in ``state.lora_global``.  With ``timers``
    the diagnostics carry host clocks, each ending in a wait on the calling
    stream only (a device-wide synchronize would wait for the side stream
    and undo the overlap): ``t_local_s`` (local phase), ``t_agg_s`` (the
    whole aggregation and apply when synchronous, else the time blocked
    landing it), ``t_overlap_s`` (in-flight time hidden behind later local
    work; 0 when synchronous) and ``t_round_s`` (``t_local_s + t_agg_s``).
    """
    if staleness < 0:
        raise ValueError(f"staleness must be >= 0, got {staleness}")
    queue = InFlightQueue(staleness)
    worker = AggWorker() if staleness else None
    side_streams: dict = {}
    adaptive = AdaptiveStaleScale()
    apply_fn = getattr(phases, "apply", None) or _default_apply
    cold_carry = getattr(phases, "cold_carry", None)
    fallback = getattr(phases, "fallback", None)
    # The carry chain head: the most recent dispatch's Future.  A one-slot
    # list so land() can sever the chain after a supervisor intervention.
    chain: list = [None]

    def land(entry: _InFlight, state):
        # An inline dispatch ran the aggregation on this thread, so its time
        # counts from the dispatch; a worker's only from the wait here.
        t0 = time.perf_counter() if isinstance(entry.out, Future) else entry.t_dispatch
        if isinstance(entry.out, Future):
            out, done, dev = entry.out.result()
            if done is not None:
                # The calling stream orders apply after the side stream's
                # work, and the update's memory is not reused by the side
                # stream until the calling stream is past apply.
                main = torch.cuda.current_stream(dev)
                main.wait_event(done)
                for t in _tensors(out[0]):
                    if t.is_cuda:
                        t.record_stream(main)
        else:
            out = entry.out
        upd, new_carry, diags = out
        finite = diags.get("update_finite")
        if finite is not None and float(finite) == 0.0:
            extra = {}
            if cold_carry is not None:
                warnings.warn(
                    f"round {entry.round_idx}: non-finite aggregation "
                    "output; retrying with a cold carry"
                )
                upd, new_carry, diags = phases.agg(cold_carry(), entry.bundle, entry.scale)
                extra["supervisor_retry"] = 1.0
                finite = diags.get("update_finite")
            if finite is not None and float(finite) == 0.0 and fallback is not None:
                warnings.warn(
                    f"round {entry.round_idx}: aggregation still non-finite "
                    "after the cold-carry retry; degrading to masked FedAvg"
                )
                upd, new_carry, diags = fallback(entry.bundle, entry.scale)
            diags = {**diags, **extra}
            chain[0] = None
        new_lora = apply_fn(state.lora_global, upd)
        if timers:
            _sync(new_lora)
        now = time.perf_counter()
        t_agg = now - t0
        adaptive.observe(diags)
        state = state._replace(lora_global=new_lora, agg_carry=new_carry)
        if on_round is not None:
            diags = {"mean_local_loss": entry.loss_mean, **diags}
            if timers:
                diags["t_local_s"] = entry.t_local
                diags["t_agg_s"] = t_agg
                diags["t_overlap_s"] = max(0.0, (now - entry.t_dispatch) - t_agg)
                diags["t_round_s"] = entry.t_local + t_agg
            on_round(entry.round_idx, state, diags)
        return state

    def dispatch(state, bundle, round_scale):
        if worker is None:
            return phases.agg(state.agg_carry, bundle, round_scale)
        prev = chain[0]
        carry0 = state.agg_carry
        dev = _cuda_device(bundle)
        ready = None
        if dev is not None:
            # The local phase's outputs are ready on the calling stream
            # once this event has passed.
            ready = torch.cuda.Event()
            ready.record(torch.cuda.current_stream(dev))
            if dev not in side_streams:
                side_streams[dev] = torch.cuda.Stream(device=dev)

        def work():
            # Single FIFO worker: prev was submitted earlier, so it has
            # already run and result() never blocks.
            carry = prev.result()[0][1] if prev is not None else carry0
            if dev is None:
                return phases.agg(carry, bundle, round_scale), None, None
            side = side_streams[dev]
            with torch.cuda.device(dev), torch.cuda.stream(side):
                side.wait_event(ready)
                out = phases.agg(carry, bundle, round_scale)
                done = torch.cuda.Event()
                done.record(side)
            side.synchronize()  # materialize on the worker
            return out, done, dev

        fut = worker.submit(work)
        chain[0] = fut
        return fut

    state = phases.prep_state(state)
    try:
        for r in range(rounds):
            tau = len(queue)
            round_scale = adaptive.scale_for(tau) if scale is None else scale
            t0 = time.perf_counter()
            # The local phase reads the CURRENT buffer: with aggregations in
            # flight, its lora_global is up to `staleness` updates behind.
            state, bundle = phases.local(state, n_active)
            if timers:
                _sync(bundle.loss_mean)
            t_local = time.perf_counter() - t0
            oldest = queue.pop_ready()
            if oldest is not None:
                state = land(oldest, state)
            t_dispatch = time.perf_counter()
            out = dispatch(state, bundle, round_scale)
            landed = queue.push(
                _InFlight(r, bundle.loss_mean, out, bundle, round_scale, t_local, t_dispatch)
            )
            if landed is not None:
                state = land(landed, state)
        for entry in queue.drain():
            state = land(entry, state)
    finally:
        if worker is not None:
            worker.close()
    return state
