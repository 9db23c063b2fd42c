"""Fault injection, the quarantine and the supervisor in the port.

* ``parse`` and ``FaultConfig`` agree with the reference field for field.
* ``FaultModel.inject``, ``delays`` and ``make_deadline_sampler`` agree
  with the reference exactly when given its ``jax.random`` draws (the
  ``draws`` hook) and its inner cohorts; on their own stream they are pure
  in (seed, round) and never empty a cohort.
* ``screen`` gives the reference's flags, mask, counts and cleaned tree,
  with NaN, inf and norm outliers among the inputs.
* The supervisor ladder: cold retry, then masked FedAvg.
* Faulted runs: a K-deep pipeline survives nan corruption (zero escapes,
  every injected fault caught), the guard turns on with faults, and runs
  with faults match the JAX package on its draws (LoRA rtol 1e-3 / atol
  1e-5, injected / caught / quarantined counts equal round by round).
"""
import dataclasses
import types
from typing import Any, NamedTuple

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.fed import FedRunConfig as JRun
from repro.fed import LocalSpec as JLocal
from repro.fed import faults as jfaults
from repro.fed import guard as jguard
from repro.fed import make_sampler as jmake_sampler
from repro.fed import run_simulation as jrun
from repro.fed import synth as jsynth
from repro.optim import make_optimizer as jopt
from repro_torch.convert import from_jax_tree
from repro_torch.core import AggregatorConfig
from repro_torch.fed import (
    FaultConfig,
    FaultModel,
    FedRunConfig,
    GuardConfig,
    LocalSpec,
    faults,
    init_round_state,
    make_deadline_sampler,
    make_round_phases,
    run_rounds,
    run_simulation,
    screen,
    synth,
)
from repro_torch.optim import make_optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map

COHORT = 8


def jax_draws(cfg):
    """The reference's draws for ``FaultModel(draws=...)``: the uniforms its
    bernoullis compare and the exponentials of its delays."""
    base = jax.random.PRNGKey(cfg.seed)

    def draws(kind, r, n):
        if kind in ("drop", "corrupt"):
            k_drop, k_cor = jax.random.split(jax.random.fold_in(base, r))
            return np.asarray(jax.random.uniform(k_drop if kind == "drop" else k_cor, (n,)))
        k_slow, k_delay = jax.random.split(jax.random.fold_in(jax.random.fold_in(base, 0x57A6), r))
        if kind == "slow":
            return np.asarray(jax.random.uniform(k_slow, (n,)))
        return np.asarray(jax.random.exponential(k_delay, (n,)))

    return draws


def delta_tree(rng, n=COHORT, noise=1.0):
    f = lambda *s: (rng.normal(size=(n, *s)) * noise).astype(np.float32)
    return {"l0": {"A": f(8, 2), "B": f(2, 8)}, "l1": {"A": f(16, 2), "B": f(2, 16)}}


def assert_trees_equal(port, ref):
    for x, y in zip(tree_leaves(port), jax.tree_util.tree_leaves(ref)):
        np.testing.assert_array_equal(x.numpy(), np.asarray(y))


# --- spec grammar -------------------------------------------------------------


@pytest.mark.parametrize("spec", ["nan:0.1", "dropout:0.2,straggler:0.5",
                                  "dropout:0.2,straggler:0.5,nan:0.1,delay:3.5,seed:7",
                                  "scale:0.3,corrupt_scale:100", "sign:0.2,deadline:2",
                                  "inf:1", "", " dropout : 0.3 , "])
def test_parse_matches_jax(spec):
    got, want = faults.parse(spec, seed=4), jfaults.parse(spec, seed=4)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.active == want.active


@pytest.mark.parametrize("spec", ["bogus", "nan", "frobnicate:0.5"])
def test_bad_specs_refused_like_jax(spec):
    for parse in (faults.parse, jfaults.parse):
        with pytest.raises(ValueError, match="--faults"):
            parse(spec)


def test_bad_config_refused():
    with pytest.raises(ValueError, match="not a probability"):
        FaultConfig(dropout=1.5)
    with pytest.raises(ValueError, match="corrupt_mode"):
        FaultConfig(corrupt_mode="zeroes")


# --- injection on the reference's draws ---------------------------------------


@pytest.mark.parametrize("mode", faults.CORRUPT_MODES)
@pytest.mark.parametrize("dropout,straggler", [(0.0, 0.0), (0.3, 0.0), (0.2, 0.5)])
def test_inject_matches_jax_on_its_draws(mode, dropout, straggler):
    cfg = dict(dropout=dropout, straggler=straggler, corrupt=0.4, corrupt_mode=mode,
               corrupt_scale=50.0, seed=3)
    ours = FaultModel(FaultConfig(**cfg), draws=jax_draws(FaultConfig(**cfg)))
    theirs = jfaults.FaultModel(jfaults.FaultConfig(**cfg))
    rng = np.random.default_rng(0)
    mask = np.array([1, 1, 1, 0, 1, 1, 1, 1], np.float32)
    for r in range(4):
        tree = delta_tree(rng)
        for stragglers in (True, False):
            got = ours.inject(r, from_jax_tree(tree), torch.from_numpy(mask),
                              stragglers=stragglers)
            want = theirs.inject(jnp.asarray(r, jnp.int32), tree, jnp.asarray(mask),
                                 stragglers=stragglers)
            assert_trees_equal(got[0], want[0])
            np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
            np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))


def test_delays_match_jax_on_its_draws():
    cfg = FaultConfig(straggler=0.5, straggler_delay_mean=3.0, seed=5)
    ours = FaultModel(cfg, draws=jax_draws(cfg))
    theirs = jfaults.FaultModel(jfaults.FaultConfig(**dataclasses.asdict(cfg)))
    for r in range(5):
        np.testing.assert_array_equal(ours.delays(r, 12).numpy(),
                                      np.asarray(theirs.delays(jnp.asarray(r), 12)))


@pytest.mark.parametrize("kind", ["uniform", "trace"])
def test_deadline_sampler_matches_jax_on_its_draws(kind):
    n, pad = 12, 4
    cfg = FaultConfig(straggler=0.5, deadline=1.0, seed=2)
    jmodel = jfaults.FaultModel(jfaults.FaultConfig(**dataclasses.asdict(cfg)))
    avail = (np.arange(n) % 3 != 0).astype(np.float32)
    jinner = jmake_sampler(kind, n, 2 * pad, availability=avail if kind == "trace" else None)
    jsample = jfaults.make_deadline_sampler(jmodel, jinner, n, pad)
    keys = jax.random.split(jax.random.PRNGKey(7), 6)
    # The port's inner sampler proposes the reference's candidates.
    inner_out = {r: jinner(jax.random.split(keys[r])[0], jnp.asarray(r, jnp.int32))
                 for r in range(6)}
    inner = lambda gen, r: tuple(torch.from_numpy(np.array(a)) for a in inner_out[r])
    sample = make_deadline_sampler(FaultModel(cfg, draws=jax_draws(cfg)), inner, n, pad)
    buffered_seat = False
    for r in range(6):
        cohort, valid = sample(None, r)
        jc, jv = jsample(keys[r], jnp.asarray(r, jnp.int32))
        np.testing.assert_array_equal(cohort.numpy(), np.asarray(jc))
        np.testing.assert_array_equal(valid.numpy(), np.asarray(jv))
        buffered_seat |= bool((valid == 0).any())
    assert buffered_seat  # some seat missed its deadline along the way


# --- the port's own stream ----------------------------------------------------


def test_own_draws_are_pure_in_seed_and_round():
    cfg = FaultConfig(dropout=0.3, straggler=0.5, corrupt=0.3, seed=1)
    a, b = FaultModel(cfg), FaultModel(cfg)
    mask = torch.ones(COHORT)
    tree = from_jax_tree(delta_tree(np.random.default_rng(1)))
    for r in (0, 3, 1):
        x, y = a.inject(r, tree, mask), b.inject(r, tree, mask)
        for u, v in zip(tree_leaves(x), tree_leaves(y)):
            assert torch.equal(u.isnan(), v.isnan()) and torch.equal(u.nan_to_num(), v.nan_to_num())
        assert torch.equal(a.delays(r, 20), b.delays(r, 20))
    assert not torch.equal(a.delays(0, 64), a.delays(1, 64))
    other = FaultModel(cfg.replace(seed=2))
    assert not torch.equal(a.delays(0, 64), other.delays(0, 64))


def test_own_draws_follow_their_rates():
    cfg = FaultConfig(dropout=0.25, straggler=0.5, straggler_delay_mean=2.0, seed=0)
    model = FaultModel(cfg)
    d = torch.cat([model.delays(r, 200) for r in range(20)])
    slow = d > 0
    assert 0.45 < float(slow.float().mean()) < 0.55
    assert 1.8 < float(d[slow].mean()) < 2.2
    kept = torch.cat([model.inject(r, {"w": torch.zeros(200, 3)}, torch.ones(200))[1]
                      for r in range(20)])
    # Kept: not dropped (0.75) and not late (1 - 0.5 * P(exp(mean 2) > 1) = 0.697).
    assert 0.48 < float(kept.mean()) < 0.57


def test_inject_never_empties_the_cohort():
    model = FaultModel(FaultConfig(dropout=1.0, seed=0))
    mask = torch.tensor([1.0, 0.0, 1.0, 1.0])
    _, new_mask, _ = model.inject(0, {"w": torch.ones(4, 2)}, mask)
    assert torch.equal(new_mask, mask)


def test_corruption_only_touches_valid_flagged_clients():
    model = FaultModel(FaultConfig(corrupt=0.5, corrupt_mode="nan", seed=4))
    mask = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 0.0, 1.0, 1.0])
    tree = from_jax_tree(delta_tree(np.random.default_rng(2)))
    for r in range(5):
        out, new_mask, slots = model.inject(r, tree, mask)
        assert torch.equal(new_mask, mask)
        assert not bool(slots[mask == 0].any())
        for leaf in tree_leaves(out):
            bad = leaf.reshape(COHORT, -1).isnan().any(dim=1)
            assert torch.equal(bad, slots > 0)


# --- the screen -----------------------------------------------------------------


def screen_case(name, rng):
    tree = delta_tree(rng)
    mask = np.ones(COHORT, np.float32)
    if name in ("nan", "mixed"):
        tree["l0"]["A"][1, 3, 0] = np.nan
    if name in ("inf", "mixed"):
        tree["l1"]["B"][4] = np.inf
    if name in ("outlier", "mixed"):
        for leaf in jax.tree_util.tree_leaves(tree):
            leaf[6] *= 1e3
    if name in ("masked", "mixed"):
        mask[2] = 0.0
        tree["l1"]["A"][2] = np.nan  # a masked slot with garbage in it
    if name == "all_bad":
        for leaf in jax.tree_util.tree_leaves(tree):
            leaf[:] = np.nan
    return tree, mask


@pytest.mark.parametrize("name", ["benign", "nan", "inf", "outlier", "masked", "mixed",
                                  "all_bad"])
@pytest.mark.parametrize("gcfg", [dict(), dict(norm_k=2.0, norm_ratio_min=1.5)])
def test_screen_matches_jax(name, gcfg):
    tree, mask = screen_case(name, np.random.default_rng(3))
    got_tree, got_mask, got = screen(from_jax_tree(tree), torch.from_numpy(mask),
                                     GuardConfig(**gcfg))
    want_tree, want_mask, want = jguard.screen(tree, jnp.asarray(mask),
                                               jguard.GuardConfig(**gcfg))
    assert_trees_equal(got_tree, want_tree)
    np.testing.assert_array_equal(got_mask.numpy(), np.asarray(want_mask))
    assert set(got) == set(want)
    for k in got:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    assert float(got["screen_clean"]) == 1.0
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(got_tree))


def test_screen_flags_what_it_should():
    tree, mask = screen_case("mixed", np.random.default_rng(3))
    _, new_mask, d = screen(from_jax_tree(tree), torch.from_numpy(mask), GuardConfig())
    assert d["flags"].tolist() == [0, 1, 0, 0, 1, 0, 1, 0]
    assert (float(d["guard_nonfinite"]), float(d["guard_norm_outliers"])) == (2.0, 1.0)
    assert new_mask.tolist() == [1, 0, 0, 1, 0, 1, 0, 1]


# --- the supervisor ladder ---------------------------------------------------------


class _StubState(NamedTuple):
    lora_global: Any
    agg_carry: Any


def stub_phases(calls, agg_fn):
    bundle = types.SimpleNamespace(loss_mean=torch.tensor(0.0))

    def fallback(b, scale):
        calls["fallback"] += 1
        return {"w": torch.tensor(2.0) * scale}, (), {"update_finite": torch.tensor(1.0),
                                                      "degraded": 1.0}

    def cold_carry():
        calls["cold"] += 1
        return ()

    return types.SimpleNamespace(
        local=lambda state, n_active=None: (state, bundle), agg=agg_fn,
        prep_state=lambda s: s, apply=lambda g, u: tree_map(lambda a, b: a + b, g, u),
        fallback=fallback, cold_carry=cold_carry,
    )


@pytest.mark.parametrize("staleness", [0, 2])
def test_nonfinite_update_retries_cold_then_degrades(staleness):
    calls = {"agg": 0, "fallback": 0, "cold": 0}

    def bad_agg(carry, bundle, scale):
        calls["agg"] += 1
        return {"w": torch.tensor(float("nan"))}, carry, {"update_finite": torch.tensor(0.0)}

    seen = []
    with pytest.warns(UserWarning, match="non-finite"):
        out = run_rounds(stub_phases(calls, bad_agg), _StubState({"w": torch.tensor(1.0)}, ()),
                         1, staleness=staleness, timers=False,
                         on_round=lambda r, s, d: seen.append(d))
    assert calls == {"agg": 2, "cold": 1, "fallback": 1}
    assert float(out.lora_global["w"]) == 3.0
    assert seen[0]["degraded"] == 1.0 and seen[0]["supervisor_retry"] == 1.0


def test_cold_retry_alone_recovers():
    calls = {"agg": 0, "fallback": 0, "cold": 0}

    def flaky_agg(carry, bundle, scale):
        calls["agg"] += 1
        if carry != ():
            return {"w": torch.tensor(float("inf"))}, carry, {"update_finite": torch.tensor(0.0)}
        return {"w": torch.tensor(5.0) * scale}, carry, {"update_finite": torch.tensor(1.0)}

    seen = []
    with pytest.warns(UserWarning, match="cold carry"):
        out = run_rounds(stub_phases(calls, flaky_agg),
                         _StubState({"w": torch.tensor(1.0)}, ("poisoned",)), 1, staleness=0,
                         timers=False, on_round=lambda r, s, d: seen.append(d))
    assert calls == {"agg": 2, "cold": 1, "fallback": 0}
    assert float(out.lora_global["w"]) == 6.0
    assert seen[0]["supervisor_retry"] == 1.0 and "degraded" not in seen[0]


def test_finite_rounds_skip_the_ladder():
    calls = {"agg": 0, "fallback": 0, "cold": 0}

    def good_agg(carry, bundle, scale):
        calls["agg"] += 1
        return {"w": torch.tensor(1.0) * scale}, carry, {"update_finite": torch.tensor(1.0)}

    out = run_rounds(stub_phases(calls, good_agg), _StubState({"w": torch.tensor(0.0)}, ()), 3,
                     staleness=0, timers=False)
    assert calls == {"agg": 3, "cold": 0, "fallback": 0}
    assert float(out.lora_global["w"]) == 3.0


# --- faulted runs -------------------------------------------------------------------


@pytest.fixture(scope="module")
def task():
    return synth.make_synth_task(n_clients=6, n_per_client=32, alpha=0.3, seed=2)


def run_cfg(task, **kw):
    kw.setdefault("rounds", 8)
    kw.setdefault("aggregator", AggregatorConfig(method="fedrpca", rpca_iters=8))
    return FedRunConfig(
        local=LocalSpec(loss_fn=lambda b, l, x: synth.loss_fn(b, l, x, task.lora_scale),
                        optimizer=make_optimizer("adam", 1e-2), local_steps=2, batch_size=16,
                        lr=1e-2),
        seed=0, **kw,
    )


def run_task(task, cfg, **kw):
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    return run_simulation(task.base, synth.init_lora(task), task.client_x, task.client_y, cfg,
                          evalf, device="cpu", **kw)


def test_k_deep_pipeline_survives_nan_corruption(task):
    cfg = run_cfg(task, pipeline=True, staleness=3,
                  faults=FaultConfig(corrupt=0.25, corrupt_mode="nan", seed=3))
    rows = []
    lora, hist = run_task(task, cfg, log_fn=lambda r, row: rows.append(row))
    assert len(rows) == 8 and len(hist) == 8
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(lora))
    assert all(row["screen_clean"] == 1.0 for row in rows)
    injected = sum(row["fault_injected"] for row in rows)
    assert injected > 0
    assert sum(row["fault_caught"] for row in rows) == injected


def test_guard_auto_enables_with_faults(task):
    cfg = run_cfg(task, rounds=3, faults=FaultConfig(corrupt=0.3, corrupt_mode="scale",
                                                     corrupt_scale=1e6, seed=1))
    rows = []
    lora, _ = run_task(task, cfg, log_fn=lambda r, row: rows.append(row))
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(lora))
    assert all("guard_quarantined" in row for row in rows)


@pytest.mark.parametrize("method", ["fedrpca", "fedavg"])
def test_guard_off_is_guard_none_without_faults(task, method):
    cfg = dataclasses.replace(run_cfg(task, rounds=3),
                              aggregator=AggregatorConfig(method=method, rpca_iters=8))
    a, ha = run_task(task, cfg)
    b, hb = run_task(task, dataclasses.replace(cfg, guard=False))
    np.testing.assert_array_equal(ha, hb)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)


def test_forced_nonfinite_round_takes_the_ladder(task):
    """Real phases: round 1's aggregation is poisoned on every try, so the
    supervisor retries it cold, then lands the masked-FedAvg fallback."""
    cfg = run_cfg(task, rounds=3, aggregator=AggregatorConfig(
        method="fedrpca", rpca_iters=8, svt_mode="subspace", carry_mode="subspace"))
    lora0 = synth.init_lora(task)
    phases = make_round_phases(task.base, task.client_x, task.client_y, cfg,
                               lora_template=lora0)
    real_agg, tries = phases.agg, []

    def agg(carry, bundle, scale):
        upd, c2, d = real_agg(carry, bundle, scale)
        tries.append(bundle.agg_key[1])
        if bundle.agg_key[1] == 1:
            upd = tree_map(lambda u: u * float("nan"), upd)
            d = {**d, "update_finite": torch.tensor(0.0)}
        return upd, c2, d

    phases.agg = agg
    rows = {}
    with pytest.warns(UserWarning, match="masked FedAvg"):
        state = run_rounds(phases, init_round_state(lora0, 6, 0), 3, staleness=2,
                           on_round=lambda r, s, d: rows.__setitem__(r, d))
    # Round 1 once on the worker, once cold on landing (round 2's dispatch on
    # the worker may come between).
    assert sorted(tries) == [0, 1, 1, 2]
    assert rows[1]["supervisor_retry"] == 1.0 and rows[1]["degraded"] == 1.0
    assert "degraded" not in rows[0] and "degraded" not in rows[2]
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(state.lora_global))


# --- faulted runs against the reference, on its draws ----------------------------------

TASK = dict(n_clients=8, n_classes=8, d_in=16, d_feat=16, n_per_client=32, n_test=256,
            lora_rank=2, alpha=0.3, seed=3)
LOCAL = dict(local_steps=3, batch_size=8, lr=1e-2)


def jax_round_draws(seed, rounds, slots, n_local, sampler=None):
    rng = jax.random.PRNGKey(seed)
    cohorts, idx = [], []
    for r in range(rounds):
        rng, sub, pick, _agg = jax.random.split(rng, 4)
        if sampler is not None:
            c, v = sampler(pick, jnp.asarray(r, jnp.int32))
            cohorts.append((np.asarray(c), np.asarray(v)))
        idx.append(np.stack([
            np.stack([np.asarray(jax.random.randint(k, (LOCAL["batch_size"],), 0, n_local))
                      for k in jax.random.split(ck, LOCAL["local_steps"])])
            for ck in jax.random.split(sub, slots)
        ]))
    return cohorts, np.stack(idx)


# (fault spec, clients_per_round, staleness)
FAULTED = [("nan:0.25,dropout:0.2", 0, 0), ("scale:0.3,corrupt_scale:1e5", 0, 2),
           ("dropout:0.2,straggler:0.5,nan:0.2", 3, 1)]


@pytest.mark.parametrize("spec,k,staleness", FAULTED)
def test_faulted_run_matches_jax(spec, k, staleness):
    rounds = 4
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    lora0 = jsynth.init_lora(jtask, seed=0)
    agg = dict(method="fedrpca", rpca_iters=10)
    common = dict(rounds=rounds, seed=0, clients_per_round=k, pipeline=staleness > 0,
                  staleness=staleness)
    jfc = jfaults.parse(spec, seed=5)
    jcfg = JRun(aggregator=JConfig(**agg), faults=jfc, **common, local=JLocal(
        loss_fn=lambda b, l, x: jsynth.loss_fn(b, l, x, jtask.lora_scale),
        optimizer=jopt("adam", LOCAL["lr"]), **LOCAL))
    jrows = []
    jlora, jhist = jrun(jtask.base, lora0, jtask.client_x, jtask.client_y, jcfg,
                        lambda l: jsynth.accuracy(jtask.base, l, jtask.test_x, jtask.test_y,
                                                  jtask.lora_scale),
                        log_fn=lambda r, d: jrows.append(d))

    n = TASK["n_clients"]
    pad = 4 if k else n
    sampler = None
    if k:
        sampler = jfaults.make_deadline_sampler(jfaults.FaultModel(jfc),
                                                jmake_sampler("uniform", n, 2 * pad), n, pad)
    cohorts, idx = jax_round_draws(0, rounds, pad, TASK["n_per_client"], sampler)
    tfc = faults.parse(spec, seed=5)
    tcfg = FedRunConfig(aggregator=AggregatorConfig(**agg), faults=tfc, **common,
                        local=LocalSpec(loss_fn=lambda b, l, x: synth.loss_fn(
                            b, l, x, ttask.lora_scale),
                            optimizer=make_optimizer("adam", LOCAL["lr"]), **LOCAL))
    trows = []
    tlora, thist = run_simulation(
        ttask.base, from_jax_tree(lora0), ttask.client_x, ttask.client_y, tcfg,
        lambda l: synth.accuracy(ttask.base, l, ttask.test_x, ttask.test_y, ttask.lora_scale),
        log_fn=lambda r, d: trows.append(d), batch_indices=lambda r: idx[r],
        cohorts=(lambda r: cohorts[r]) if k else None, fault_draws=jax_draws(tfc),
        device="cpu",
    )
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(thist, jhist, atol=2.0 / TASK["n_test"] + 1e-9)
    keys = ("fault_injected", "fault_caught", "guard_quarantined", "guard_nonfinite",
            "guard_norm_outliers", "screen_clean", "update_finite", "bytes_up")
    for t, j in zip(trows, jrows):
        assert {kk: t[kk] for kk in keys} == {kk: float(j[kk]) for kk in keys}
    assert sum(t["fault_injected"] for t in trows) > 0
