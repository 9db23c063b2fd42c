"""The port's tracing (``repro_torch.utils.trace``) on the CPU.

Off, a span is one check: no record, counter, CUDA event or autograd hook.
Under a CPU ``torch.profiler.profile`` the program's spans nest with the
right parents and share their round's and call's ids, a span's self time is
its duration less its children's, each record lies within 100 us of the
profiler's range of the same span (the shared clock), ``host_syncs`` counts
every read of a tensor on the host that the ADMM loop and a session call
make (``Tensor.__bool__`` / ``__int__`` / ``__float__`` / ``item`` patched to
count them), the ``rpca.exact.*`` reasons sum to ``fallback_count``, and the
gradients of ``apply_moe`` and ``lora_matmul`` are bit-equal with tracing on
and off.  This file imports no JAX.
"""
import contextlib
import types
from typing import NamedTuple

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from repro_torch.core import AggregatorConfig, aggregate_planned, init_agg_carry, plan_aggregation
from repro_torch.core import rpca
from repro_torch.fed.pipeline import run_rounds
from repro_torch.kernels import lora_matmul
from repro_torch.models import moe
from repro_torch.utils import trace
from repro_torch.utils.pytree import tree_map


@pytest.fixture(autouse=True)
def fresh_trace():
    trace.reset()
    yield
    trace.reset()


def profiled():
    return profile(activities=[ProfilerActivity.CPU])


def planted_bucket(seed, b=3, vec=48, d2=10, rank=2, spikes=0.05):
    """(b, vec, d2) low-rank columns plus sparse spikes: after the cold
    exact step the live rank stays under the subspace width, so the loop
    takes Ritz attempts too."""
    gen = torch.Generator().manual_seed(seed)
    u = torch.randn((b, vec, rank), generator=gen)
    w = torch.randn((b, rank, d2), generator=gen)
    sp = torch.randn((b, vec, d2), generator=gen)
    keep = torch.rand((b, vec, d2), generator=gen) < spikes
    return u @ w + torch.where(keep, 5.0 * sp, torch.zeros_like(sp))


def session_tree(seed, n=10, layers=2, d_in=12, d_out=16, r=4, drift=0.0):
    """A stacked (n clients) q/v LoRA delta tree of low-rank client deltas."""
    gen = torch.Generator().manual_seed(seed)
    tree = {}
    for t in ("q", "v"):
        a_core = torch.randn((layers * d_in * r, 2), generator=gen)
        b_core = torch.randn((layers * r * d_out, 2), generator=gen)
        mix = torch.randn((2, n), generator=gen) * (1.0 + drift)
        tree[t] = {"A": (a_core @ mix).T.reshape(n, layers, d_in, r).contiguous(),
                   "B": (b_core @ mix).T.reshape(n, layers, r, d_out).contiguous()}
    return tree


SESSION = AggregatorConfig(method="fedrpca", rpca_iters=12, svt_mode="subspace", svt_rank=4,
                           svt_sweeps=2, carry_mode="subspace")


class HostReads:
    """Counts every ``__bool__``, ``__int__``, ``__float__`` and ``item`` of
    a tensor while active."""

    def __init__(self, monkeypatch):
        self.n = 0
        for name in ("__bool__", "__int__", "__float__", "item"):
            orig = getattr(torch.Tensor, name)

            def counted(t, *a, _orig=orig, **kw):
                self.n += 1
                return _orig(t, *a, **kw)

            monkeypatch.setattr(torch.Tensor, name, counted)


# ---------------------------------------------------------------------------
# Off
# ---------------------------------------------------------------------------


class Boom:
    """Any attribute read raises: proves a code path never touched it."""

    def __getattr__(self, name):
        raise AssertionError(f"tracing off touched {name}")


def test_off_records_nothing_and_makes_no_event_or_hook(monkeypatch):
    assert not trace.enabled()

    def no_record(*a, **kw):
        raise AssertionError("a record was made with tracing off")

    monkeypatch.setattr(trace, "_Record", no_record)
    monkeypatch.setattr(torch.cuda, "Event", no_record)
    assert trace.span("repro.x") is trace.span("repro.y")  # the shared null context
    trace.backward_span("repro.z", Boom(), Boom())  # returns before reading a grad_fn
    trace.count("c")
    trace.sync("eigh", "cuda")
    assert trace.host_read(torch.tensor(2.5), "x", float) == 2.5
    # The program's instrumented paths, off: a MoE layer's forward and
    # backward, a LoRA product's, a subspace ADMM loop, a session call.
    _, p = moe_layer()
    x = torch.randn((2, 6, 16), requires_grad=True)
    out, aux = moe.apply_moe(p, x, top_k=2, capacity_factor=1.0, groups=2)
    (out.sum() + aux.sum()).backward()
    lora_grads(torch.Generator().manual_seed(0))
    rpca.robust_pca_bucket(planted_bucket(0), n_iter=6, svt_mode="subspace", svt_rank=4)
    tree = session_tree(1)
    plan = plan_aggregation(tree, SESSION)
    aggregate_planned(plan, tree, init_agg_carry(plan))
    s = trace.summary()
    assert s == {"spans": {}, "counters": {}, "rounds": 0, "calls": 0, "dropped": 0}


# ---------------------------------------------------------------------------
# Nesting, ids, self time, the shared clock
# ---------------------------------------------------------------------------


class State(NamedTuple):
    lora_global: dict
    agg_carry: dict
    round_idx: int


def tiny_phases(plan, trees):
    """``run_rounds`` phases whose local phase hands on a prepared delta
    tree and whose aggregation is a session call."""

    def local(state, n_active=None):
        bundle = types.SimpleNamespace(deltas=trees[state.round_idx],
                                       loss_mean=torch.tensor(1.0))
        return state._replace(round_idx=state.round_idx + 1), bundle

    def agg(carry, bundle, scale):
        upd, carry2, diag = aggregate_planned(plan, bundle.deltas, carry, with_diagnostics=True)
        return tree_map(lambda u: scale * u, upd), carry2, {"fallbacks": diag.scalars[
            "fallback_count"]}

    return types.SimpleNamespace(local=local, agg=agg, prep_state=lambda s: s,
                                 apply=lambda g, u: tree_map(torch.add, g, u))


def test_round_spans_nest_and_share_ids():
    trees = [session_tree(2, drift=0.01 * i) for i in range(2)]
    plan = plan_aggregation(trees[0], SESSION)
    glob = tree_map(lambda x: torch.zeros_like(x[0]), trees[0])
    state = State(glob, init_agg_carry(plan), 0)
    with profiled():
        run_rounds(tiny_phases(plan, trees), state, 2)
    recs = trace.records()
    by_seq = {r["seq"]: r for r in recs}
    rounds = [r for r in recs if r["name"] == "repro.round"]
    calls = [r for r in recs if r["name"] == "repro.agg.call"]
    assert len(rounds) == 2 and len(calls) == 2
    s = trace.summary()
    assert s["rounds"] == 2 and s["calls"] == 2 and s["dropped"] == 0

    def chain(r):
        out = []
        while r["parent"] is not None:
            r = by_seq[r["parent"]]
            out.append(r["name"])
        return out

    want = {
        "repro.round.local": ["repro.round"],
        "repro.round.agg": ["repro.round"],
        "repro.agg.call": ["repro.round.agg", "repro.round"],
        "repro.round.apply": ["repro.round.agg", "repro.round"],
        "repro.engine.pack": ["repro.agg.call", "repro.round.agg", "repro.round"],
        "repro.engine.tier": ["repro.agg.call", "repro.round.agg", "repro.round"],
        "repro.engine.unpack": ["repro.agg.call", "repro.round.agg", "repro.round"],
        "repro.rpca.admm": ["repro.engine.tier", "repro.agg.call", "repro.round.agg",
                            "repro.round"],
        "repro.rpca.svt_exact": ["repro.rpca.admm", "repro.engine.tier", "repro.agg.call",
                                 "repro.round.agg", "repro.round"],
        "repro.rpca.apply": ["repro.rpca.admm", "repro.engine.tier", "repro.agg.call",
                             "repro.round.agg", "repro.round"],
    }
    for name, parents in want.items():
        got = [r for r in recs if r["name"] == name]
        assert got, name
        for r in got:
            assert chain(r) == parents, (name, chain(r))
    for r in recs:
        # Every span inside a round carries that round's id; every span
        # inside an aggregation call carries the call's id.
        up = [by_seq[r["seq"]]]
        while up[-1]["parent"] is not None:
            up.append(by_seq[up[-1]["parent"]])
        rnd = next(u for u in up if u["name"] == "repro.round")
        assert r["round"] == rnd["seq"]
        call = next((u for u in up if u["name"] == "repro.agg.call"), None)
        if call is not None:
            assert r["call"] == call["seq"]
    assert rounds[0]["round"] != rounds[1]["round"]
    assert calls[0]["call"] != calls[1]["call"]


def test_self_time_is_duration_less_children():
    with profiled():
        with trace.span("repro.p"):
            for _ in range(3):
                with trace.span("repro.c"):
                    with trace.span("repro.g"):
                        torch.randn(64, 64) @ torch.randn(64, 64)
            torch.randn(64, 64) @ torch.randn(64, 64)
    recs = {r["name"]: [] for r in trace.records()}
    for r in trace.records():
        recs[r["name"]].append(r)
    dur = lambda r: r["end_ns"] - r["start_ns"]
    (p,) = recs["repro.p"]
    s = trace.summary()["spans"]
    assert s["repro.p"]["self_s"] == pytest.approx(
        (dur(p) - sum(dur(c) for c in recs["repro.c"])) / 1e9, abs=1e-12)
    assert s["repro.c"]["self_s"] == pytest.approx(
        sum(dur(c) - dur(g) for c, g in zip(recs["repro.c"], recs["repro.g"])) / 1e9, abs=1e-12)
    assert s["repro.g"]["self_s"] == pytest.approx(s["repro.g"]["host_s"], abs=1e-12)
    assert s["repro.c"]["calls"] == 3 and s["repro.p"]["device_ms"] is None


def test_records_lie_on_the_profilers_clock():
    """Each record's start and end within 100 us of the profiler's range of
    the same span (kineto stamps ``time.time_ns``'s clock)."""
    with profiled():
        with trace.span("repro.warm"):
            pass
    trace.reset()
    with profiled() as prof:
        with trace.span("repro.outer"):
            for _ in range(5):
                with trace.span("repro.inner"):
                    torch.randn(128, 128) @ torch.randn(128, 128)
    ranges = {}
    for e in prof.profiler.kineto_results.events():
        if e.name().startswith("repro."):
            ranges.setdefault(e.name(), []).append((e.start_ns(), e.start_ns() + e.duration_ns()))
    recs = {}
    for r in trace.records():
        recs.setdefault(r["name"], []).append((r["start_ns"], r["end_ns"]))
    assert sorted(ranges) == sorted(recs) == ["repro.inner", "repro.outer"]
    for name in recs:
        assert len(ranges[name]) == len(recs[name])
        for (s0, e0), (s1, e1) in zip(sorted(ranges[name]), sorted(recs[name])):
            assert abs(s1 - s0) <= 100_000 and abs(e1 - e0) <= 100_000, (name, s1 - s0, e1 - e0)


def test_buffer_is_bounded(monkeypatch):
    monkeypatch.setattr(trace, "MAX_RECORDS", 8)
    trace.reset()
    with profiled():
        for _ in range(20):
            with trace.span("repro.x"):
                pass
    s = trace.summary()
    assert s["spans"]["repro.x"]["calls"] == 8 and s["dropped"] == 12


# ---------------------------------------------------------------------------
# Host reads and the exact-eigh reasons
# ---------------------------------------------------------------------------


def sync_counts():
    c = trace.summary()["counters"]
    return c.get("host_syncs", 0), c.get("sync.eigh", 0), c


@pytest.mark.parametrize("tol", [None, 1e-6])
def test_host_syncs_count_every_read_of_the_admm_loop(monkeypatch, tol):
    m = planted_bucket(3)
    # A carry from a first call, so the second call also reads its gate.
    _, carry = rpca.robust_pca_bucket(m, n_iter=10, svt_mode="subspace", svt_rank=4,
                                      return_carry=True)
    reads = HostReads(monkeypatch)
    with profiled():
        res = rpca.robust_pca_bucket(m * 1.01, n_iter=20, tol=tol, svt_mode="subspace",
                                     svt_rank=4, carry=carry, return_carry=True)[0]
    syncs, eigh, c = sync_counts()
    assert reads.n > 0 and syncs - eigh == reads.n
    assert c["sync.warm_gate"] == 1
    assert c.get("sync.svt_accept", 0) > 0  # the loop took Ritz attempts
    assert c.get("sync.admm_tol", 0) == (0 if tol is None else int(res.n_iter.max()) + (
        int(res.n_iter.max()) < 20))
    falls = sum(v for k, v in c.items() if k.startswith("rpca.exact."))
    assert falls == res.n_fallback


def test_host_syncs_count_every_read_of_a_session_call(monkeypatch):
    trees = [session_tree(4, drift=0.01 * i) for i in range(3)]
    plan = plan_aggregation(trees[0], SESSION)
    carry = init_agg_carry(plan)
    _, carry = aggregate_planned(plan, trees[0], carry)
    reads = HostReads(monkeypatch)
    with profiled():
        _, carry, diag = aggregate_planned(plan, trees[1], carry, with_diagnostics=True)
    syncs, eigh, c = sync_counts()
    assert reads.n > 0 and syncs - eigh == reads.n
    assert trace.summary()["calls"] == 1
    monkeypatch.undo()
    falls = sum(v for k, v in c.items() if k.startswith("rpca.exact."))
    assert falls == int(diag.scalars["fallback_count"])


def test_exact_reasons_sum_to_fallback_count():
    """Over a cold and two warm calls of a session: the cold start, the
    saturated routes and the rejected Ritz attempts."""
    trees = [session_tree(5, drift=0.2 * i) for i in range(3)]
    plan = plan_aggregation(trees[0], SESSION)
    carry = init_agg_carry(plan)
    total = 0
    with profiled():
        for tree in trees:
            _, carry, diag = aggregate_planned(plan, tree, carry, with_diagnostics=True)
            total += int(diag.scalars["fallback_count"])
    c = trace.summary()["counters"]
    reasons = {k: v for k, v in c.items() if k.startswith("rpca.exact.")}
    assert sum(reasons.values()) == total
    assert reasons.get("rpca.exact.cold", 0) >= 1


# ---------------------------------------------------------------------------
# Gradients with tracing on and off
# ---------------------------------------------------------------------------


def moe_layer(d=16, f=24, e=4, seed=7):
    p = moe.init_moe(torch.Generator().manual_seed(seed), d, f, e, dtype=torch.float32,
                     device="cpu")
    return (d, f, e), p


def moe_grads(traced: bool):
    (d, _, _), p = moe_layer()
    for w in (p.router["w"], p.gate, p.up, p.down):
        w.requires_grad_()
    x = torch.randn((4, 10, d), generator=torch.Generator().manual_seed(8)).requires_grad_()
    g = torch.randn((4, 10, d), generator=torch.Generator().manual_seed(9))
    with profiled() if traced else contextlib.nullcontext():
        out, aux = moe.apply_moe(p, x, top_k=2, capacity_factor=0.6, groups=2)
        grads = torch.autograd.grad((out * g).sum() + aux.sum(),
                                    [x, p.router["w"], p.gate, p.up, p.down])
    return out, grads


def test_moe_gradients_bit_equal_with_tracing_on_and_off():
    out0, g0 = moe_grads(False)
    assert trace.summary()["spans"] == {}
    out1, g1 = moe_grads(True)
    assert torch.equal(out0, out1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    spans = trace.summary()["spans"]
    for name in ("route", "dispatch", "experts", "combine", "dispatch.backward",
                 "combine.backward"):
        assert spans["repro.moe." + name]["calls"] == 1, name


def lora_grads(gen, traced=False):
    m, k, n, r, slots = 12, 16, 20, 4, 3
    x = torch.randn((m, k), generator=gen).requires_grad_()
    w = torch.randn((k, n), generator=gen)
    a = torch.randn((slots, k, r), generator=gen).requires_grad_()
    b = torch.randn((slots, r, n), generator=gen).requires_grad_()
    rs = torch.randint(-1, slots, (m,), generator=gen, dtype=torch.int32)
    g = torch.randn((m, n), generator=gen)
    with profiled() if traced else contextlib.nullcontext():
        y = lora_matmul.gathered_lora_matmul(x, w, a, b, rs, 0.5)
        grads = torch.autograd.grad((y * g).sum(), [x, a, b])
    return y, grads


def test_lora_gradients_bit_equal_with_tracing_on_and_off():
    y0, g0 = lora_grads(torch.Generator().manual_seed(11))
    y1, g1 = lora_grads(torch.Generator().manual_seed(11), traced=True)
    assert torch.equal(y0, y1)
    for a, b in zip(g0, g1):
        assert torch.equal(a, b)
    spans = trace.summary()["spans"]
    assert spans["repro.lora.forward"]["calls"] == 1
    assert spans["repro.lora.backward"]["calls"] == 1
