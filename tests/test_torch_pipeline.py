"""The port's round pipeline: its primitives against the JAX package, the
staleness-0 contract port against port, K-deep rounds, and pipelined runs
against the JAX package.

* ``InFlightQueue``, ``stale_scale`` and ``AdaptiveStaleScale`` agree with
  the reference value for value on the same inputs.
* ``pipeline=True, staleness=0`` gives the same bits as ``pipeline=False``
  for every method on both engines, with a carry session and at partial
  participation (port against port).
* ``staleness=K`` lands rounds in order, threads the carry between
  dispatches and still trains.
* Port against JAX at staleness 1 and 2 on the reference's minibatch
  indices: the final LoRA at rtol 1e-3 / atol 1e-5 and the history within
  2 test examples, as in ``tests/test_torch_round.py`` (the damping follows
  the landed residuals, which agree to fp32 round-off).
"""
import dataclasses
import time
import types
from typing import Any, NamedTuple

import jax
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.fed import AdaptiveStaleScale as JAdaptive
from repro.fed import FedRunConfig as JRun
from repro.fed import InFlightQueue as JQueue
from repro.fed import LocalSpec as JLocal
from repro.fed import run_simulation as jrun
from repro.fed import stale_scale as jstale_scale
from repro.fed import synth as jsynth
from repro.optim import make_optimizer as jopt
from repro_torch.convert import from_jax_tree
from repro_torch.core import AggregatorConfig
from repro_torch.core.aggregators import METHODS
from repro_torch.fed import (
    AdaptiveStaleScale,
    FedRunConfig,
    InFlightQueue,
    LocalSpec,
    init_round_state,
    make_round_phases,
    rounds_to_reach,
    run_rounds,
    run_simulation,
    stale_scale,
    synth,
)
from repro_torch.optim import make_optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map


@pytest.fixture(scope="module")
def task():
    return synth.make_synth_task(n_clients=6, n_per_client=32, alpha=0.3, seed=2)


def spec_for(task, **kw):
    return LocalSpec(
        loss_fn=lambda base, lora, b: synth.loss_fn(base, lora, b, task.lora_scale),
        optimizer=make_optimizer("adam", 1e-2), local_steps=2, batch_size=16, lr=1e-2, **kw,
    )


def cfg_for(task, method="fedrpca", rounds=2, agg_kw=None, **kw):
    agg = {"rpca_iters": 8} if method == "fedrpca" else {}
    agg.update(agg_kw or {})
    return FedRunConfig(aggregator=AggregatorConfig(method=method, **agg),
                        local=spec_for(task), rounds=rounds, seed=0, **kw)


def run(task, cfg, **kw):
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    return run_simulation(task.base, synth.init_lora(task), task.client_x, task.client_y, cfg,
                          evalf, device="cpu", **kw)


def assert_same_bits(a, b):
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


# --- primitives against the reference ----------------------------------------


@pytest.mark.parametrize("depth", [0, 1, 2, 3])
def test_in_flight_queue_matches_jax(depth):
    """The same push / pop_ready / drain script gives the same results."""
    logs = []
    for q in (InFlightQueue(depth), JQueue(depth)):
        log = [(q.pop_ready(), q.push(item), len(q)) for item in range(7)]
        logs.append(log + [list(q.drain()), len(q)])
    assert logs[0] == logs[1]


def test_in_flight_queue_refusals_match_jax():
    for cls in (InFlightQueue, JQueue):
        with pytest.raises(ValueError):
            cls(-1)
        q = cls(1)
        q.push("a")
        with pytest.raises(RuntimeError):
            q.push("b")


@pytest.mark.parametrize("tau", [0, 1, 2, 3, 7])
def test_stale_scale_matches_jax(tau):
    assert stale_scale(tau) == jstale_scale(tau)


def test_stale_scale_refuses_negative():
    with pytest.raises(ValueError):
        stale_scale(-1)


def test_adaptive_stale_scale_matches_jax():
    """The EMA over a residual stream with a missing value, a NaN and an inf
    (skipped) gives the reference's scale at every tau, value for value."""
    ours, theirs = AdaptiveStaleScale(), JAdaptive(decay=0.9)
    stream = [{}, {"rpca_residual_max": 0.2}, {"rpca_residual_max": 0.05},
              {"rpca_residual_max": float("nan")}, {"rpca_residual_max": 3.0},
              {"rpca_residual_max": float("inf")}, {"rpca_residual_max": torch.tensor(0.01)}]
    for diags in stream:
        jdiags = {k: float(v) for k, v in diags.items()}
        ours.observe(diags)
        theirs.observe(jdiags)
        assert (ours.ema, ours.last) == (theirs.ema, theirs.last)
        for tau in (0, 1, 2, 5):
            assert ours.scale_for(tau) == theirs.scale_for(tau)


# --- staleness 0 is the synchronous round, bit for bit ----------------------


@pytest.mark.parametrize("engine", ["packed", "reference"])
@pytest.mark.parametrize("method", METHODS)
def test_staleness_zero_is_bitwise_synchronous(task, method, engine):
    cfg = cfg_for(task, method=method, engine=engine)
    lora_sync, hist_sync = run(task, cfg)
    lora_pipe, hist_pipe = run(task, dataclasses.replace(cfg, pipeline=True, staleness=0))
    np.testing.assert_array_equal(hist_sync, hist_pipe)
    assert_same_bits(lora_sync, lora_pipe)


def test_staleness_zero_carry_session_bitwise(task):
    agg = dict(svt_mode="subspace", carry_mode="subspace")
    cfg = cfg_for(task, rounds=3, agg_kw=agg)
    lora_sync, hist_sync = run(task, cfg)
    lora_pipe, hist_pipe = run(task, dataclasses.replace(cfg, pipeline=True, staleness=0))
    np.testing.assert_array_equal(hist_sync, hist_pipe)
    assert_same_bits(lora_sync, lora_pipe)


def test_staleness_zero_partial_participation_bitwise(task):
    cfg = dataclasses.replace(cfg_for(task, rounds=3, clients_per_round=4),
                              local=spec_for(task, scaffold=True))
    lora_sync, hist_sync = run(task, cfg, n_active=3)
    lora_pipe, hist_pipe = run(task, dataclasses.replace(cfg, pipeline=True, staleness=0),
                               n_active=3)
    np.testing.assert_array_equal(hist_sync, hist_pipe)
    assert_same_bits(lora_sync, lora_pipe)


def test_round_zero_lands_undamped(task):
    cfg = cfg_for(task, rounds=1)
    lora_sync, _ = run(task, cfg)
    lora_pipe, _ = run(task, dataclasses.replace(cfg, pipeline=True, staleness=1))
    assert_same_bits(lora_sync, lora_pipe)


# --- pipelined rounds --------------------------------------------------------


@pytest.mark.parametrize("staleness", [1, 3])
def test_rounds_land_in_order_with_timers(task, staleness):
    cfg = cfg_for(task, rounds=6, pipeline=True, staleness=staleness)
    logs = []
    lora, hist = run(task, cfg, log_fn=lambda r, d: logs.append((r, d)))
    assert [r for r, _ in logs] == list(range(6)) and len(hist) == 6
    for _, d in logs:
        assert {"t_local_s", "t_agg_s", "t_overlap_s", "t_round_s"} <= set(d)
        assert d["t_local_s"] >= 0 and d["t_agg_s"] >= 0 and d["t_overlap_s"] >= 0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(lora))


class _Stub(NamedTuple):
    lora_global: Any
    agg_carry: Any


@pytest.mark.parametrize("staleness", [0, 1])
def test_timers_count_the_aggregation(staleness):
    """The port aggregates eagerly: inline (staleness 0) the whole
    aggregation lands in ``t_agg_s``; on the worker, behind the next local
    phase, it shows as ``t_overlap_s``."""
    bundle = types.SimpleNamespace(loss_mean=torch.tensor(0.0))

    def local(state, n_active=None):
        time.sleep(0.05)
        return state, bundle

    def agg(carry, b, scale):
        time.sleep(0.04)
        return {"w": torch.tensor(1.0)}, carry, {}

    phases = types.SimpleNamespace(local=local, agg=agg, prep_state=lambda s: s)
    rows = []
    run_rounds(phases, _Stub({"w": torch.tensor(0.0)}, ()), 3, staleness=staleness,
               on_round=lambda r, s, d: rows.append(d))
    for d in rows:
        assert d["t_local_s"] >= 0.05
        assert d["t_agg_s"] + d["t_overlap_s"] >= 0.04  # the aggregation shows somewhere
        if staleness == 0:
            assert d["t_agg_s"] >= 0.04 and d["t_overlap_s"] == 0.0
    if staleness:
        # Rounds 0 and 1 land after the next local phase hid their aggregation.
        assert all(d["t_overlap_s"] > 0.0 for d in rows[:2])


def test_staleness_one_converges(task):
    cfg = cfg_for(task, rounds=10)
    _, hist_sync = run(task, cfg)
    _, hist_pipe = run(task, dataclasses.replace(cfg, pipeline=True, staleness=1))
    assert hist_pipe[-1] >= hist_sync[-1] - 0.05
    assert rounds_to_reach(hist_pipe) <= rounds_to_reach(hist_sync) + 1


@pytest.mark.parametrize("staleness", [1, 3])
def test_carry_hands_off_between_inflight_dispatches(task, staleness):
    cfg = cfg_for(task, rounds=5, pipeline=True, staleness=staleness,
                  agg_kw=dict(svt_mode="subspace", carry_mode="subspace"))
    logs = []
    lora, hist = run(task, cfg, log_fn=lambda r, d: logs.append(d))
    assert len(hist) == 5
    assert {"fallback_count", "live_rank_mean", "carry_hit_rate"} <= set(logs[-1])
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(lora))


def test_agg_returns_the_scaled_update(task):
    """Half the scale is half the update, and ``apply`` adds it to the
    global it lands on; the local phase leaves the global alone."""
    cfg = cfg_for(task, rounds=1)
    lora0 = synth.init_lora(task)
    phases = make_round_phases(task.base, task.client_x, task.client_y, cfg,
                               lora_template=lora0)
    state1, bundle = phases.local(init_round_state(lora0, 6, 0))
    assert_same_bits(state1.lora_global, lora0)
    full, _, _ = phases.agg(state1.agg_carry, bundle, 1.0)
    half, _, _ = phases.agg(state1.agg_carry, bundle, 0.5)
    for f, h in zip(tree_leaves(full), tree_leaves(half)):
        torch.testing.assert_close(h, 0.5 * f, rtol=1e-6, atol=1e-7)
    assert_same_bits(phases.apply(lora0, full), tree_map(lambda g, u: g + u, lora0, full))


def test_run_rounds_rejects_negative_staleness(task):
    cfg = cfg_for(task)
    phases = make_round_phases(task.base, task.client_x, task.client_y, cfg)
    with pytest.raises(ValueError):
        run_rounds(phases, init_round_state(synth.init_lora(task), 6, 0), 1, staleness=-1)


# --- pipelined runs against the reference -----------------------------------

TASK = dict(n_clients=4, n_classes=8, d_in=16, d_feat=16, n_per_client=32, n_test=256,
            lora_rank=2, alpha=0.3, seed=3)
LOCAL = dict(local_steps=3, batch_size=8, lr=1e-2)


def jax_batch_indices(seed, rounds, slots, n_local):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        rng, sub, _pick, _agg = jax.random.split(rng, 4)
        out.append(np.stack([
            np.stack([np.asarray(jax.random.randint(k, (LOCAL["batch_size"],), 0, n_local))
                      for k in jax.random.split(ck, LOCAL["local_steps"])])
            for ck in jax.random.split(sub, slots)
        ]))
    return np.stack(out)


@pytest.mark.parametrize("staleness", [1, 2])
@pytest.mark.parametrize("agg", [dict(method="fedrpca", rpca_iters=10),
                                 dict(method="fedrpca", rpca_iters=10, svt_mode="subspace",
                                      carry_mode="subspace"),
                                 dict(method="fedavg")])
def test_pipelined_run_matches_jax(staleness, agg):
    rounds = 4
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    lora0 = jsynth.init_lora(jtask, seed=0)
    jcfg = JRun(aggregator=JConfig(**agg), rounds=rounds, seed=0, pipeline=True,
                staleness=staleness,
                local=JLocal(loss_fn=lambda b, l, batch: jsynth.loss_fn(b, l, batch,
                                                                        jtask.lora_scale),
                             optimizer=jopt("adam", LOCAL["lr"]), **LOCAL))
    jlogs = []
    jlora, jhist = jrun(jtask.base, lora0, jtask.client_x, jtask.client_y, jcfg,
                        lambda l: jsynth.accuracy(jtask.base, l, jtask.test_x, jtask.test_y,
                                                  jtask.lora_scale),
                        log_fn=lambda r, d: jlogs.append(r))
    idx = jax_batch_indices(0, rounds, TASK["n_clients"], TASK["n_per_client"])
    tcfg = FedRunConfig(aggregator=AggregatorConfig(**agg), rounds=rounds, seed=0,
                        pipeline=True, staleness=staleness,
                        local=LocalSpec(loss_fn=lambda b, l, batch: synth.loss_fn(
                            b, l, batch, ttask.lora_scale),
                            optimizer=make_optimizer("adam", LOCAL["lr"]), **LOCAL))
    tlogs = []
    tlora, thist = run_simulation(
        ttask.base, from_jax_tree(lora0), ttask.client_x, ttask.client_y, tcfg,
        lambda l: synth.accuracy(ttask.base, l, ttask.test_x, ttask.test_y, ttask.lora_scale),
        log_fn=lambda r, d: tlogs.append(r), batch_indices=lambda r: idx[r], device="cpu",
    )
    assert tlogs == jlogs == list(range(rounds))
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(thist, jhist, atol=2.0 / TASK["n_test"] + 1e-9)
