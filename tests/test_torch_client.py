"""The port's batched client objectives against the JAX package.

FedProx, SCAFFOLD (the refreshed variates included) and MOON local runs
go through the reference's ``make_local_fn`` vmapped over clients and
through the port's batched ``make_local_fn``, on the same numpy task, the
same starting state and the reference's ``jax.random`` minibatch indices:
local models, deltas, variates and final losses are held to rtol 1e-4 /
atol 1e-6 (fp32 autograd over a few optimizer steps).  The early exit:
masked slots return exact zeros, an untouched variate, a loss of 0 and the
global model, and the active slots equal the unmasked run.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.fed import LocalSpec as JLocal
from repro.fed import make_local_fn as jmake_local_fn
from repro.fed import synth as jsynth
from repro.optim import make_optimizer as jopt
from repro_torch.convert import from_jax_tree
from repro_torch.fed import LocalSpec, make_local_fn, synth
from repro_torch.optim import make_optimizer
from repro_torch.utils.pytree import tree_leaves

TASK = dict(n_clients=4, n_classes=8, d_in=16, d_feat=16, n_per_client=32, n_test=64,
            lora_rank=2, alpha=0.3, seed=3)
STEPS, BATCH, LR = 4, 8, 1e-2

METHODS = {
    "plain": {},
    "fedprox": dict(fedprox_mu=0.5),
    "scaffold": dict(scaffold=True),
    "moon": dict(moon_mu=0.5),
    "prox+scaffold": dict(fedprox_mu=0.5, scaffold=True),
    "all": dict(fedprox_mu=0.1, scaffold=True, moon_mu=0.3, moon_temp=0.7),
}


def start_state(seed, n):
    """A nonzero global LoRA, server and client variates and previous local
    models, as numpy float32."""
    rng = np.random.default_rng(seed)
    f = lambda *s, scale=1.0: (scale * rng.standard_normal(s)).astype(np.float32)
    d, r = TASK["d_in"], TASK["lora_rank"]
    glob = {"A": f(d, r, scale=0.25), "B": f(r, d, scale=0.1)}
    c = {"A": f(d, r, scale=0.05), "B": f(r, d, scale=0.05)}
    ci = {"A": f(n, d, r, scale=0.05), "B": f(n, r, d, scale=0.05)}
    prev = {"A": f(n, d, r, scale=0.25), "B": f(n, r, d, scale=0.1)}
    return glob, c, ci, prev


def jax_indices(rngs, n_local):
    """The reference's per-client minibatch indices: (n, steps, batch)."""
    return np.stack([
        np.stack([np.asarray(jax.random.randint(k, (BATCH,), 0, n_local))
                  for k in jax.random.split(ck, STEPS)])
        for ck in rngs
    ])


def both_specs(opt, **kw):
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    jspec = JLocal(
        loss_fn=lambda b, l, batch: jsynth.loss_fn(b, l, batch, jtask.lora_scale),
        feature_fn=lambda b, l, x: jsynth.features(b, l, x, jtask.lora_scale),
        optimizer=jopt(opt, LR), local_steps=STEPS, batch_size=BATCH, lr=LR, **kw,
    )
    tspec = LocalSpec(
        loss_fn=lambda b, l, batch: synth.loss_fn(b, l, batch, ttask.lora_scale),
        feature_fn=lambda b, l, x: synth.features(b, l, x, ttask.lora_scale),
        optimizer=make_optimizer(opt, LR), local_steps=STEPS, batch_size=BATCH, lr=LR, **kw,
    )
    return jtask, ttask, jspec, tspec


def run_both(method, opt, active=None, seed=0):
    jtask, ttask, jspec, tspec = both_specs(opt, **METHODS[method])
    n = TASK["n_clients"]
    glob, c, ci, prev = start_state(seed, n)
    rngs = jax.random.split(jax.random.PRNGKey(seed), n)
    jfn = jmake_local_fn(jspec)
    args = (jtask.base, glob, jtask.client_x, jtask.client_y, rngs, c, ci, prev)
    if active is None:
        jres = jax.vmap(jfn, in_axes=(None, None, 0, 0, 0, None, 0, 0))(*args)
    else:
        jres = jax.vmap(jfn, in_axes=(None, None, 0, 0, 0, None, 0, 0, 0))(
            *args, jnp.asarray(active, jnp.float32))
    idx = torch.from_numpy(jax_indices(rngs, TASK["n_per_client"]))
    tfn = make_local_fn(tspec)
    tres = tfn(ttask.base, from_jax_tree(glob), ttask.client_x, ttask.client_y, idx,
               c=from_jax_tree(c), ci=from_jax_tree(ci), prev_lora=from_jax_tree(prev),
               active=None if active is None else torch.tensor(active, dtype=torch.float32))
    return jres, tres, (glob, ci)


def assert_result_close(jres, tres, rtol=1e-4, atol=1e-6):
    for field in ("lora", "delta", "new_ci"):
        for t, j in zip(tree_leaves(getattr(tres, field)),
                        jax.tree_util.tree_leaves(getattr(jres, field))):
            np.testing.assert_allclose(t.numpy(), np.asarray(j), rtol=rtol, atol=atol,
                                       err_msg=field)
    np.testing.assert_allclose(tres.final_loss.numpy(), np.asarray(jres.final_loss),
                               rtol=rtol, atol=atol)


@pytest.mark.parametrize("method", list(METHODS))
@pytest.mark.parametrize("opt", ["adam", "sgd"])
def test_local_run_matches_jax(method, opt):
    jres, tres, _ = run_both(method, opt)
    assert_result_close(jres, tres)


@pytest.mark.parametrize("method", ["plain", "scaffold", "moon", "all"])
def test_masked_local_run_matches_jax(method):
    """The vmapped reference with ``active`` (a select over both lanes)
    against the port, which runs only the active rows."""
    jres, tres, _ = run_both(method, "adam", active=[1.0, 0.0, 1.0, 0.0], seed=1)
    assert_result_close(jres, tres)


@pytest.mark.parametrize("method", ["scaffold", "all"])
def test_masked_slots_are_exact_zeros(method):
    active = [0.0, 1.0, 0.0, 1.0]
    _, tres, (glob, ci) = run_both(method, "adam", active=active, seed=2)
    _, full, _ = run_both(method, "adam", active=None, seed=2)
    off, on = torch.tensor([0, 2]), torch.tensor([1, 3])
    for leaf in tree_leaves(tres.delta):
        assert torch.equal(leaf[off], torch.zeros_like(leaf[off]))
    for got, want in zip(tree_leaves(tres.new_ci), tree_leaves(from_jax_tree(ci))):
        assert torch.equal(got[off], want[off])
    for got, want in zip(tree_leaves(tres.lora), tree_leaves(from_jax_tree(glob))):
        assert torch.equal(got[off], want.expand_as(got[off]))
    assert torch.equal(tres.final_loss[off], torch.zeros(2))
    # The active rows are the unmasked run's rows (per-client batched math).
    for got, want in zip(tree_leaves(tres.delta), tree_leaves(full.delta)):
        torch.testing.assert_close(got[on], want[on], rtol=1e-6, atol=1e-7)


def test_all_masked_runs_nothing():
    _, ttask, _, tspec = both_specs("adam", scaffold=True)
    n = TASK["n_clients"]
    glob, c, ci, prev = start_state(0, n)
    idx = torch.zeros((n, STEPS, BATCH), dtype=torch.int64)
    res = make_local_fn(tspec)(ttask.base, from_jax_tree(glob), ttask.client_x, ttask.client_y,
                               idx, c=from_jax_tree(c), ci=from_jax_tree(ci),
                               prev_lora=from_jax_tree(prev), active=torch.zeros(n))
    assert all(not bool(d.any()) for d in tree_leaves(res.delta))
    assert not bool(res.final_loss.any())


def test_defaults_are_zero_variates_and_global_prev():
    """c, ci and prev_lora default to zeros and the global model: the same
    run as passing them."""
    _, ttask, _, tspec = both_specs("adam", scaffold=True, moon_mu=0.5)
    n = TASK["n_clients"]
    glob = from_jax_tree(start_state(0, n)[0])
    idx = torch.randint(0, TASK["n_per_client"], (n, STEPS, BATCH),
                        generator=torch.Generator().manual_seed(0))
    fn = make_local_fn(tspec)
    a = fn(ttask.base, glob, ttask.client_x, ttask.client_y, idx)
    zeros = {k: torch.zeros((n, *v.shape)) for k, v in glob.items()}
    prev = {k: v.expand(n, *v.shape).clone() for k, v in glob.items()}
    b = fn(ttask.base, glob, ttask.client_x, ttask.client_y, idx,
           c={k: torch.zeros_like(v) for k, v in glob.items()}, ci=zeros, prev_lora=prev)
    for x, y in zip(tree_leaves(a), tree_leaves(b)):
        assert torch.equal(x, y)
