"""Partial participation in the port: samplers, the padded cohort, the state
scatter and ``n_active``.

The samplers draw on the port's own CPU generator, so they are checked
statistically (no replacement, availability respected, size skew, ties to
the lower index).  ``run_simulation`` at partial participation is held
against the JAX package with the reference's ``jax.random`` cohorts and
minibatch indices injected (its key chain: ``rng, sub, pick, agg =
split(rng, 4)`` a round, the sampler on ``pick``, the clients' batches from
``split(sub, cohort_pad)``): the final LoRA at rtol 1e-3 / atol 1e-5 and
the accuracy history within 2 test examples, as in
``tests/test_torch_round.py``.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.fed import FedRunConfig as JRun
from repro.fed import LocalSpec as JLocal
from repro.fed import make_sampler as jmake_sampler
from repro.fed import run_simulation as jrun
from repro.fed import synth as jsynth
from repro.optim import make_optimizer as jopt
from repro_torch.convert import from_jax_tree
from repro_torch.core import AggregatorConfig
from repro_torch.fed import (
    SAMPLERS,
    FedRunConfig,
    LocalSpec,
    init_round_state,
    make_round_fn,
    make_sampler,
    run_simulation,
    synth,
)
from repro_torch.optim import make_optimizer
from repro_torch.utils.pytree import tree_leaves

TASK = dict(n_clients=8, n_classes=8, d_in=16, d_feat=16, n_per_client=32, n_test=256,
            lora_rank=2, alpha=0.3, seed=3)
LOCAL = dict(local_steps=3, batch_size=8, lr=1e-2)
# Two availability rows: 5 of 8 clients, then 2 of 8 (a cohort with holes).
AVAIL = np.array([[1, 1, 0, 1, 0, 1, 1, 0], [0, 1, 0, 0, 0, 0, 1, 0]], np.float32)
WEIGHTS = np.linspace(1.0, 3.0, TASK["n_clients"])


def jax_round_draws(seed, rounds, slots, n_local, sampler=None):
    """The reference's cohorts ((cohort, slot_valid) a round, or None) and
    (rounds, slots, steps, batch) minibatch indices."""
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


def port_local(task, **kw):
    return LocalSpec(
        loss_fn=lambda b, l, batch: synth.loss_fn(b, l, batch, task.lora_scale),
        feature_fn=lambda b, l, x: synth.features(b, l, x, task.lora_scale),
        optimizer=make_optimizer("adam", LOCAL["lr"]), **LOCAL, **kw,
    )


def jax_local(task, **kw):
    return JLocal(
        loss_fn=lambda b, l, batch: jsynth.loss_fn(b, l, batch, task.lora_scale),
        feature_fn=lambda b, l, x: jsynth.features(b, l, x, task.lora_scale),
        optimizer=jopt("adam", LOCAL["lr"]), **LOCAL, **kw,
    )


# (aggregator kwargs, sampler, client objective, n_active, engine)
PARITY = [
    (dict(method="fedavg"), "uniform", dict(scaffold=True), None, "packed"),
    (dict(method="fedrpca", rpca_iters=10, weighting="data_size_rpca"), "size_weighted", {},
     None, "packed"),
    (dict(method="fedrpca", rpca_iters=10, svt_mode="subspace"), "trace", dict(moon_mu=0.3),
     None, "packed"),
    (dict(method="fedrpca", rpca_iters=10), "uniform", dict(fedprox_mu=0.1), 2, "reference"),
    (dict(method="task_arithmetic"), "trace", dict(scaffold=True, fedprox_mu=0.1), None,
     "reference"),
]


@pytest.mark.parametrize("agg,sampler,client,n_active,engine", PARITY)
def test_partial_participation_matches_jax(agg, sampler, client, n_active, engine):
    rounds, k = 3, 3
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    lora0 = jsynth.init_lora(jtask, seed=0)
    kw = dict(availability=AVAIL if sampler == "trace" else None, client_weights=WEIGHTS)
    jcfg = JRun(aggregator=JConfig(**agg), local=jax_local(jtask, **client), rounds=rounds,
                seed=0, engine=engine, clients_per_round=k, sampler=sampler)
    jeval = lambda l: jsynth.accuracy(jtask.base, l, jtask.test_x, jtask.test_y,
                                      jtask.lora_scale)
    jlora, jhist = jrun(jtask.base, lora0, jtask.client_x, jtask.client_y, jcfg, jeval,
                        n_active=n_active, **kw)

    pad = 4  # canonical_cohort_size(3)
    jsampler = jmake_sampler(sampler, TASK["n_clients"], pad, availability=kw["availability"],
                             weights=WEIGHTS)
    cohorts, idx = jax_round_draws(0, rounds, pad, TASK["n_per_client"], jsampler)
    if sampler == "trace":
        assert cohorts[1][1].tolist() == [1.0, 1.0, 0.0, 0.0]  # a round with holes
    tcfg = FedRunConfig(aggregator=AggregatorConfig(**agg), local=port_local(ttask, **client),
                        rounds=rounds, seed=0, engine=engine, clients_per_round=k,
                        sampler=sampler)
    teval = lambda l: synth.accuracy(ttask.base, l, ttask.test_x, ttask.test_y,
                                     ttask.lora_scale)
    tlora, thist = run_simulation(
        ttask.base, from_jax_tree(lora0), ttask.client_x, ttask.client_y, tcfg, teval,
        n_active=n_active, batch_indices=lambda r: idx[r], cohorts=lambda r: cohorts[r],
        device="cpu", **kw,
    )
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(thist, jhist, atol=2.0 / TASK["n_test"] + 1e-9)


# --- samplers, on the port's own stream --------------------------------------


def draw(sample, seed, round_idx=0):
    cohort, valid = sample(torch.Generator().manual_seed(seed), round_idx)
    return cohort.numpy(), valid.numpy()


@pytest.mark.parametrize("kind,kw", [("uniform", {}),
                                     ("size_weighted", dict(weights=np.arange(1.0, 17.0))),
                                     ("trace", dict(availability=np.ones(16)))])
def test_samplers_draw_without_replacement(kind, kw):
    sample = make_sampler(kind, 16, 8, **kw)
    seen = set()
    for seed in range(20):
        cohort, valid = draw(sample, seed)
        assert cohort.dtype == np.int64 and cohort.shape == (8,)
        assert len(set(cohort.tolist())) == 8 and set(cohort.tolist()) <= set(range(16))
        assert valid.dtype == np.float32 and (valid == 1.0).all()
        seen |= set(cohort.tolist())
    assert seen == set(range(16))  # every client gets drawn


def test_uniform_sampler_is_uniform():
    sample = make_sampler("uniform", 16, 4)
    counts = np.zeros(16)
    for seed in range(400):
        counts[draw(sample, seed)[0]] += 1
    # Each client is drawn with probability 1/4: 100 of 400 expected.
    assert counts.min() > 65 and counts.max() < 135, counts


def test_trace_respects_availability_and_marks_the_rest():
    avail = np.concatenate([np.ones(6), np.zeros(10)])
    sample = make_sampler("trace", 16, 8, availability=avail)
    for seed in range(10):
        cohort, valid = draw(sample, seed)
        assert set(cohort[valid > 0]) == set(range(6))
        assert valid.tolist() == [1.0] * 6 + [0.0] * 2
        # Unavailable clients all score -1: the tie goes to the lower index.
        assert cohort[6:].tolist() == [6, 7]


def test_trace_cycles_rows_by_round():
    avail = np.stack([np.r_[np.ones(8), np.zeros(8)], np.r_[np.zeros(8), np.ones(8)]])
    sample = make_sampler("trace", 16, 4, availability=avail)
    c0, c1, c2 = (draw(sample, 0, r)[0] for r in range(3))
    assert set(c0) <= set(range(8)) and set(c1) <= set(range(8, 16))
    np.testing.assert_array_equal(c0, c2)


def test_size_weighted_skews_sampling():
    w = np.r_[np.full(8, 100.0), np.full(8, 0.01)]
    sample = make_sampler("size_weighted", 16, 4, weights=w)
    counts = np.zeros(16)
    for seed in range(40):
        counts[draw(sample, seed)[0]] += 1
    assert counts[:8].sum() > 0.95 * counts.sum()


def test_sampler_is_a_function_of_the_generator():
    for kind, kw in (("uniform", {}), ("size_weighted", dict(weights=WEIGHTS)),
                     ("trace", dict(availability=AVAIL))):
        sample = make_sampler(kind, 8, 4, **kw)
        a, b = draw(sample, 5, 1), draw(sample, 5, 1)
        np.testing.assert_array_equal(a[0], b[0])
        np.testing.assert_array_equal(a[1], b[1])


def test_unknown_and_missing_sampler_args_rejected():
    with pytest.raises(ValueError, match="unknown sampler"):
        make_sampler("roundrobin", 16, 8)
    with pytest.raises(ValueError, match="availability"):
        make_sampler("trace", 16, 8)
    with pytest.raises(ValueError, match="weights"):
        make_sampler("size_weighted", 16, 8)
    with pytest.raises(ValueError, match="covers"):
        make_sampler("trace", 16, 8, availability=np.ones(4))


# --- rounds ------------------------------------------------------------------


@pytest.fixture(scope="module")
def task16():
    return synth.make_synth_task(n_clients=16, n_per_client=24, alpha=0.4, seed=9)


def round_cfg(task, method="fedavg", local_kw=None, **kw):
    agg = dict(method=method, rpca_iters=5) if method == "fedrpca" else dict(method=method)
    return FedRunConfig(aggregator=AggregatorConfig(**agg),
                        local=port_local(task, **(local_kw or {})), rounds=1, **kw)


def changed_rows(new, old, n):
    return {i for a, b in zip(tree_leaves(new), tree_leaves(old))
            for i in np.flatnonzero((a != b).reshape(n, -1).any(dim=1).numpy())}


def test_masked_slots_do_not_touch_state(task16):
    """Only the valid slots of the cohort write their variates and previous
    local models back, and SCAFFOLD's server variate moves."""
    cfg = round_cfg(task16, local_kw=dict(scaffold=True), clients_per_round=8)
    cohort = torch.tensor([3, 11, 0, 7, 5, 9, 14, 2])
    valid = torch.tensor([1.0, 1.0, 0.0, 1.0, 1.0, 1.0, 1.0, 1.0])
    round_fn = make_round_fn(task16.base, task16.client_x, task16.client_y, cfg,
                             cohorts=lambda r: (cohort, valid))
    assert round_fn.cohort_pad == 8
    state = init_round_state(synth.init_lora(task16), 16, 0)
    new, diags = round_fn(state, 5)
    want = {3, 11, 7, 5}  # slots 0-4 valid by n_active, slot 2 a hole
    assert changed_rows(new.prev_local, state.prev_local, 16) == want
    assert changed_rows(new.scaffold_ci, state.scaffold_ci, 16) == want
    assert any(bool(c.any()) for c in tree_leaves(new.scaffold_c))
    per_client = 4.0 * sum(int(np.prod(x.shape)) for x in tree_leaves(state.lora_global))
    assert float(diags["bytes_up"]) == per_client * 4
    assert new.round_idx == 1


def test_n_active_is_validated(task16):
    cfg = round_cfg(task16, clients_per_round=6)
    round_fn = make_round_fn(task16.base, task16.client_x, task16.client_y, cfg)
    state = init_round_state(synth.init_lora(task16), 16, 0)
    for bad in (0, 9):
        with pytest.raises(ValueError, match="out of range"):
            round_fn(state, bad)
    full = make_round_fn(task16.base, task16.client_x, task16.client_y,
                         round_cfg(task16))
    with pytest.raises(ValueError, match="full-participation"):
        full(state, 3)
    run = lambda c, n: run_simulation(task16.base, synth.init_lora(task16), task16.client_x,
                                      task16.client_y, c, lambda l: 0.0, n_active=n,
                                      device="cpu")
    with pytest.raises(ValueError, match="out of range"):
        run(cfg, 9)
    with pytest.raises(ValueError, match="full-participation"):
        run(round_cfg(task16), 3)
    with pytest.raises(ValueError, match="clients_per_round"):
        make_round_fn(task16.base, task16.client_x, task16.client_y,
                      round_cfg(task16, clients_per_round=17))


@pytest.mark.parametrize("kind", SAMPLERS)
def test_every_sampler_runs_a_round(task16, kind):
    cfg = round_cfg(task16, clients_per_round=8, sampler=kind)
    round_fn = make_round_fn(task16.base, task16.client_x, task16.client_y, cfg,
                             client_weights=np.linspace(1.0, 2.0, 16),
                             availability=np.ones((2, 16)) if kind == "trace" else None)
    state, diags = round_fn(init_round_state(synth.init_lora(task16), 16, 0))
    assert np.isfinite(float(diags["mean_local_loss"]))
    assert state.round_idx == 1


@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_rpca_diag_keys_at_partial_participation(task16, engine):
    cfg = round_cfg(task16, method="fedrpca", clients_per_round=6, engine=engine)
    round_fn = make_round_fn(task16.base, task16.client_x, task16.client_y, cfg)
    _, diags = round_fn(init_round_state(synth.init_lora(task16), 16, 0), 5)
    assert set(diags) == {"mean_local_loss", "beta_mean", "energy_mean", "rpca_residual_max",
                          "update_finite", "bytes_up", "bytes_down"}
    assert all(np.isfinite(float(v)) for v in diags.values())


def test_own_stream_runs_are_reproducible(task16):
    cfg = round_cfg(task16, method="fedrpca", clients_per_round=5, sampler="size_weighted")
    cfg = FedRunConfig(**{**cfg.__dict__, "rounds": 3})
    run = lambda: run_simulation(task16.base, synth.init_lora(task16), task16.client_x,
                                 task16.client_y, cfg, lambda l: 0.0, device="cpu",
                                 client_weights=np.linspace(1.0, 2.0, 16))
    (a, _), (b, _) = run(), run()
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y) and bool(torch.isfinite(x).all())
