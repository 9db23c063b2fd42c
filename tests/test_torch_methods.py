"""Port merging methods (ties, fedexp, task arithmetic, dare) against the JAX
package on both engines, dense, masked and weighted.

Updates are held to atol 1e-5 * max|delta|, the bound of
``tests/test_torch_engine.py`` (fp32 means, elections and top-k thresholds
reassociate sums only).  DARE draws its keep masks on a CPU
``torch.Generator``, not from ``jax.random``: the parity cases inject the
reference's masks by monkeypatching the port's ``_dare_keep`` (no new
public argument), and the port's own stream is checked statistically and
port against port (slot-stable masks, card-independent bits).
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.core import METHODS as JMETHODS
from repro.core import aggregate as jaggregate
from repro.core import aggregators as jagg
from repro_torch.convert import from_jax_tree
from repro_torch.core import METHODS, AggregatorConfig, aggregate, dare, fedexp, ties_merging
from repro_torch.core import aggregators as tagg
from repro_torch.utils.pytree import tree_leaves

TOL = 1e-5
VARIANTS = ["dense", "masked", "weighted"]


def mixed_tree(seed, nc):
    """Leaves of several buckets and sizes (an (A, B) pair, a head, an odd
    leaf) with planted low-rank cores, sparse spikes and noise."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        vec = int(np.prod(s[1:]))
        low = rng.normal(size=(vec, 2)) @ rng.normal(size=(2, nc))
        sp = np.where(rng.random((vec, nc)) < 0.05, 5.0 * rng.normal(size=(vec, nc)), 0.0)
        noise = 0.3 * rng.normal(size=(vec, nc))
        return np.moveaxis(low + sp + noise, -1, 0).reshape(s).astype(np.float32)

    return {"blocks": {"attn": {"A": mk(nc, 4, 6, 8), "B": mk(nc, 4, 8, 6)}},
            "head": mk(nc, 12, 4), "odd": mk(nc, 10, 10), "wide": mk(nc, 900)}


def inputs(variant, nc=8, seed=3):
    tree = mixed_tree(seed, nc)
    mask = weights = None
    if variant in ("masked", "weighted"):
        mask = (np.arange(nc) < nc - 2).astype(np.float32)
        mask[1] = 0.0
        for leaf in jax.tree_util.tree_leaves(tree):
            leaf[mask == 0] = 0.0
    if variant == "weighted":
        weights = np.linspace(1.0, 3.0, nc).astype(np.float32)
    return tree, mask, weights


def assert_tree_close(got, want, scale):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(np.asarray(g, np.float64), np.asarray(w, np.float64),
                                   rtol=0, atol=TOL * scale)


def tree_scale(tree):
    return max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(tree))


def opt(x, conv):
    return None if x is None else conv(x)


@functools.lru_cache(maxsize=None)
def jax_update(method, extra, variant, engine):
    tree, mask, weights = inputs(variant)
    out = jaggregate(
        jax.tree_util.tree_map(jnp.asarray, tree), JConfig(method=method, **dict(extra)),
        engine=engine, mask=opt(mask, jnp.asarray), weights=opt(weights, jnp.asarray),
    )
    return [np.asarray(x) for x in jax.tree_util.tree_leaves(out)]


CASES = [("ties", {}), ("ties", {"ties_keep": 0.13, "ties_scale": 1.5}),
         ("ties", {"ties_keep": 0.5}), ("fedexp", {}), ("task_arithmetic", {"beta": 2.5})]


def test_methods_are_the_reference_set():
    assert METHODS == JMETHODS


@pytest.mark.parametrize("engine", ["packed", "reference"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("method,extra", CASES, ids=lambda v: str(v))
def test_merging_methods_match_jax(method, extra, variant, engine):
    tree, mask, weights = inputs(variant)
    want = jax_update(method, tuple(sorted(extra.items())), variant, engine)
    got = aggregate(from_jax_tree(tree), AggregatorConfig(method=method, **extra), engine=engine,
                    mask=opt(mask, torch.from_numpy), weights=opt(weights, torch.from_numpy),
                    device="cpu")
    assert_tree_close(got, want, tree_scale(tree))


def test_ties_k_uses_host_arithmetic():
    """k is the host's ``max(int(keep * d), 1)`` in double precision, not a
    float32 product; both engines take it, as the reference does."""
    rng = np.random.default_rng(5)
    tree = {"w": rng.normal(size=(6, 900)).astype(np.float32)}
    cfg = dict(method="ties", ties_keep=0.13)
    want = jaggregate({"w": jnp.asarray(tree["w"])}, JConfig(**cfg), engine="reference")
    for engine in ("packed", "reference"):
        got = aggregate(from_jax_tree(tree), AggregatorConfig(**cfg), engine=engine, device="cpu")
        np.testing.assert_allclose(got["w"].numpy(), np.asarray(want["w"]), rtol=0, atol=1e-6)
    kept = ties_merging({"w": torch.from_numpy(tree["w"][:1])}, keep=0.13)["w"]
    assert int((kept != 0).sum()) == int(0.13 * 900)


def test_direct_functions_equal_the_reference_engine():
    tree, mask, weights = inputs("weighted")
    t = from_jax_tree(tree)
    m, w = torch.from_numpy(mask), torch.from_numpy(weights)
    for got, cfg in ((ties_merging(t, 0.2, 1.0, mask=m, weights=w),
                      AggregatorConfig(method="ties", ties_keep=0.2)),
                     (fedexp(t, mask=m, weights=w), AggregatorConfig(method="fedexp"))):
        ref = aggregate(t, cfg, engine="reference", mask=m, weights=w, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(ref)))


def test_fedexp_extrapolates_diverse_clients():
    """Orthogonal client deltas get eta > 1; identical ones eta = 1."""
    eye = torch.eye(4)[:, None, :].repeat(1, 3, 1)
    out = fedexp({"w": eye})["w"]
    assert float(out.abs().max()) > float(eye.mean(0).abs().max())
    same = torch.ones((4, 3, 4))
    assert torch.equal(fedexp({"w": same})["w"], same.mean(0))


# ---------------------------------------------------------------------------
# DARE
# ---------------------------------------------------------------------------


def inject_jax_keep(monkeypatch, seed):
    """The port's keep masks become the reference's for ``PRNGKey(seed)``."""
    jkey = jax.random.PRNGKey(seed)

    def keep(key, leaf_index, leaf_shape, drop_rate, mask=None):
        jmask = None if mask is None else jnp.asarray(np.asarray(mask))
        k = jagg._dare_keep(jkey, leaf_index, tuple(leaf_shape), drop_rate, jmask)
        return torch.from_numpy(np.array(k))

    monkeypatch.setattr(tagg, "_dare_keep", keep)
    return jkey


@pytest.mark.parametrize("engine", ["packed", "reference"])
@pytest.mark.parametrize("variant", VARIANTS)
@pytest.mark.parametrize("drop", [0.5, 0.9])
def test_dare_matches_jax_with_its_keep_masks(monkeypatch, drop, variant, engine):
    tree, mask, weights = inputs(variant)
    jkey = inject_jax_keep(monkeypatch, 7)
    want = jaggregate(jax.tree_util.tree_map(jnp.asarray, tree),
                      JConfig(method="dare", dare_drop=drop), engine=engine, key=jkey,
                      mask=opt(mask, jnp.asarray), weights=opt(weights, jnp.asarray))
    got = aggregate(from_jax_tree(tree), AggregatorConfig(method="dare", dare_drop=drop),
                    engine=engine, key=7, mask=opt(mask, torch.from_numpy),
                    weights=opt(weights, torch.from_numpy), device="cpu")
    assert_tree_close(got, want, tree_scale(tree) / (1.0 - drop))


def test_dare_needs_a_key():
    tree = {"w": torch.ones((4, 8))}
    with pytest.raises(ValueError, match="PRNG key"):
        dare(tree, 0.5)
    for engine in ("packed", "reference"):
        with pytest.raises(ValueError, match="PRNG key"):
            aggregate(tree, AggregatorConfig(method="dare"), engine=engine, device="cpu")


def test_dare_stream_statistics():
    """The port's own keep masks: the kept share is 1 - p within 5 sigma,
    leaves and keys draw different patterns, a key repeats its pattern, and
    the rescaled mean is unbiased over many keys."""
    n = 200_000
    for drop in (0.5, 0.9):
        keep = tagg._dare_keep(3, 0, (4, n // 4), drop)
        assert keep.dtype == torch.bool and keep.shape == (4, n // 4)
        p = 1.0 - drop
        assert abs(float(keep.float().mean()) - p) < 5.0 * (p * (1 - p) / n) ** 0.5
    a = tagg._dare_keep(3, 0, (8, 64), 0.5)
    assert torch.equal(a, tagg._dare_keep(3, 0, (8, 64), 0.5))
    assert torch.equal(a, tagg._dare_keep((3,), 0, (8, 64), 0.5))
    assert not torch.equal(a, tagg._dare_keep(4, 0, (8, 64), 0.5))
    assert not torch.equal(a, tagg._dare_keep(3, 1, (8, 64), 0.5))
    leaf = torch.from_numpy(np.random.default_rng(0).normal(size=(4, 16)).astype(np.float32))
    outs = torch.stack([dare({"w": leaf}, 0.5, key=k)["w"] for k in range(400)])
    se = float(leaf.abs().max()) / (4 * 400) ** 0.5 * 2
    assert float((outs.mean(0) - leaf.mean(0)).abs().max()) < 5 * se


@pytest.mark.parametrize("engine", ["packed", "reference"])
def test_dare_masked_slots_are_stable(engine):
    """With a mask, slot j draws from (key, leaf, j): a cohort padded to 8
    slots and the dense 5 give the same update, and every slot's pattern is
    that of its own draw."""
    tree, _, _ = inputs("dense", nc=5, seed=9)
    padded = jax.tree_util.tree_map(
        lambda x: np.concatenate([x, np.zeros((3,) + x.shape[1:], np.float32)]), tree)
    cfg = AggregatorConfig(method="dare", dare_drop=0.5)
    mask8 = torch.tensor([1.0] * 5 + [0.0] * 3)
    got = aggregate(from_jax_tree(padded), cfg, engine=engine, key=11, mask=mask8, device="cpu")
    want = aggregate(from_jax_tree(tree), cfg, engine=engine, key=11, mask=torch.ones(5),
                     device="cpu")
    for g, w in zip(tree_leaves(got), tree_leaves(want)):
        torch.testing.assert_close(g, w, rtol=0, atol=1e-6)
    k8 = tagg._dare_keep(11, 2, (8, 6, 4), 0.5, mask8)
    k5 = tagg._dare_keep(11, 2, (5, 6, 4), 0.5, torch.ones(5))
    assert torch.equal(k8[:5], k5)


def test_dare_packed_equals_reference_in_port():
    tree, mask, weights = inputs("weighted")
    kw = dict(key=(2, 5), mask=torch.from_numpy(mask), weights=torch.from_numpy(weights),
              device="cpu")
    cfg = AggregatorConfig(method="dare", dare_drop=0.7)
    p = aggregate(from_jax_tree(tree), cfg, engine="packed", **kw)
    r = aggregate(from_jax_tree(tree), cfg, engine="reference", **kw)
    for a, b in zip(tree_leaves(p), tree_leaves(r)):
        torch.testing.assert_close(a, b, rtol=0, atol=1e-6 * tree_scale(tree))


def test_round_loop_runs_the_new_methods():
    """run_simulation takes ties, fedexp and dare (a key per round)."""
    from repro_torch.fed import FedRunConfig, LocalSpec, run_simulation, synth
    from repro_torch.optim import make_optimizer

    task = synth.make_synth_task(n_clients=4, n_classes=8, d_in=16, d_feat=16, n_per_client=32,
                                 n_test=128, lora_rank=2, seed=3)
    local = LocalSpec(loss_fn=lambda b, l, batch: synth.loss_fn(b, l, batch, task.lora_scale),
                      optimizer=make_optimizer("adam", 1e-2), local_steps=2, batch_size=8,
                      lr=1e-2)
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    for method in ("ties", "fedexp", "dare"):
        cfg = FedRunConfig(aggregator=AggregatorConfig(method=method, dare_drop=0.5),
                           local=local, rounds=2, seed=0)
        lora, hist = run_simulation(task.base, synth.init_lora(task), task.client_x,
                                    task.client_y, cfg, evalf, device="cpu")
        assert np.isfinite(hist).all() and len(hist) == 2
        assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(lora))
