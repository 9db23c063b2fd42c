"""Port round loop against the JAX package, and the paper's claim on the
port's own RNG.

Parity injects the reference's LoRA init and its ``jax.random`` minibatch
draws (the key chain of ``fed/server.py`` local phase -> ``fed/client.py``)
so both packages train on the same batches: the final LoRA is held to
rtol 1e-3 / atol 1e-5 (fp32 autograd and Adam over 3 rounds of local
steps) and the accuracy history to 2 test examples.
"""
import jax
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.fed import FedRunConfig as JRun
from repro.fed import LocalSpec as JLocal
from repro.fed import run_simulation as jrun
from repro.fed import synth as jsynth
from repro.optim import make_optimizer as jopt
from repro_torch.convert import from_jax_tree
from repro_torch.core import AggregatorConfig
from repro_torch.fed import FedRunConfig, LocalSpec, rounds_to_reach, run_simulation, synth
from repro_torch.optim import make_optimizer
from repro_torch.utils.pytree import tree_leaves

TASK = dict(n_clients=4, n_classes=8, d_in=16, d_feat=16, n_per_client=32, n_test=256,
            lora_rank=2, alpha=0.3, seed=3)
LOCAL = dict(local_steps=4, batch_size=8, lr=1e-2)


def jax_batch_indices(seed, rounds, n_clients, local_steps, batch, n_local):
    """The reference's per-round minibatch indices: (rounds, n_clients,
    local_steps, batch), from the round state's key chain."""
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        rng, sub, _pick, _agg = jax.random.split(rng, 4)
        per_client = []
        for ck in jax.random.split(sub, n_clients):
            keys = jax.random.split(ck, local_steps)
            per_client.append([
                np.asarray(jax.random.randint(k, (batch,), 0, n_local)) for k in keys
            ])
        out.append(np.asarray(per_client))
    return np.stack(out)


def port_local(task, **kw):
    loss = lambda base, lora, batch: synth.loss_fn(base, lora, batch, task.lora_scale)
    return LocalSpec(loss_fn=loss, optimizer=make_optimizer("adam", kw["lr"]), **kw)


@pytest.mark.parametrize("method,svt_mode", [("fedavg", "gram"), ("fedrpca", "gram"),
                                             ("fedrpca", "subspace")])
@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_run_simulation_matches_jax(method, svt_mode, engine):
    rounds = 3
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    assert np.array_equal(ttask.client_x.numpy(), np.asarray(jtask.client_x))
    lora0 = jsynth.init_lora(jtask, seed=0)
    agg = dict(method=method, rpca_iters=10, svt_mode=svt_mode)
    jcfg = JRun(
        aggregator=JConfig(**agg), rounds=rounds, seed=0, engine=engine,
        local=JLocal(
            loss_fn=lambda b, l, batch: jsynth.loss_fn(b, l, batch, jtask.lora_scale),
            optimizer=jopt("adam", LOCAL["lr"]), **LOCAL,
        ),
    )
    jeval = lambda l: jsynth.accuracy(jtask.base, l, jtask.test_x, jtask.test_y, jtask.lora_scale)
    jlora, jhist = jrun(jtask.base, lora0, jtask.client_x, jtask.client_y, jcfg, jeval)

    idx = jax_batch_indices(0, rounds, TASK["n_clients"], LOCAL["local_steps"],
                            LOCAL["batch_size"], TASK["n_per_client"])
    tcfg = FedRunConfig(aggregator=AggregatorConfig(**agg), local=port_local(ttask, **LOCAL),
                        rounds=rounds, seed=0, engine=engine)
    teval = lambda l: synth.accuracy(ttask.base, l, ttask.test_x, ttask.test_y, ttask.lora_scale)
    tlora, thist = run_simulation(
        ttask.base, from_jax_tree(lora0), ttask.client_x, ttask.client_y, tcfg, teval,
        batch_indices=lambda r: idx[r], device="cpu",
    )
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(thist, jhist, atol=2.0 / TASK["n_test"] + 1e-9)


def test_fedrpca_not_worse_than_fedavg():
    """Paper Table 1 direction on the port's own RNG (the twin of
    tests/test_fed.py::TestSimulation::test_fedrpca_not_worse_than_fedavg)."""
    task = synth.make_synth_task(n_clients=12, n_per_client=48, alpha=0.3, seed=1)
    local = port_local(task, local_steps=6, batch_size=24, lr=1e-2)
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    final = {}
    for method in ("fedavg", "fedrpca"):
        cfg = FedRunConfig(aggregator=AggregatorConfig(method=method, rpca_iters=40),
                           local=local, rounds=15, seed=0)
        _, hist = run_simulation(task.base, synth.init_lora(task, seed=0), task.client_x,
                                 task.client_y, cfg, evalf, device="cpu")
        assert np.isfinite(hist).all() and len(hist) == 15
        final[method] = hist[-1]
    assert final["fedrpca"] >= final["fedavg"] - 0.01, final


def test_run_simulation_needs_an_explicit_cpu(monkeypatch):
    """Without CUDA the default device raises instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    task = synth.make_synth_task(**TASK)
    cfg = FedRunConfig(aggregator=AggregatorConfig(method="fedavg"),
                       local=port_local(task, **LOCAL), rounds=1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        run_simulation(task.base, synth.init_lora(task), task.client_x, task.client_y, cfg,
                       lambda l: 0.0)


@pytest.mark.parametrize("field,value", [("uplink", "sketch"), ("client_ranks", "2,1")])
def test_unported_round_options_raise(field, value):
    """Both options are ported now and no longer raise: under fedavg the
    sketch uplink has no carried basis, so it warns and runs the dense
    round bit for bit; client ranks zero-mask the rank-1 clients' deltas
    beyond rank 1, which moves the global's second rank row."""
    task = synth.make_synth_task(**TASK)
    run = lambda **kw: run_simulation(
        task.base, synth.init_lora(task, seed=0), task.client_x, task.client_y,
        FedRunConfig(aggregator=AggregatorConfig(method="fedavg"),
                     local=port_local(task, **LOCAL), rounds=1, **kw),
        lambda l: 0.0, device="cpu")[0]
    plain = run()
    if field == "uplink":
        with pytest.warns(UserWarning, match="running dense"):
            got = run(**{field: value})
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(plain)))
    else:
        got = run(**{field: value})
        assert all(bool(torch.isfinite(a).all()) for a in tree_leaves(got))
        assert not all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(plain)))


def test_rounds_to_reach():
    assert rounds_to_reach(np.asarray([0.1, 0.5, 0.8, 0.85, 0.9]), 0.9) == 4
    assert rounds_to_reach(np.asarray([])) == -1
