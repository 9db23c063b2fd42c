"""The port's diagnostics and tree helpers that no path calls, each against
its JAX twin on the CPU on shared numpy inputs: ``core/metrics.py``'s
``client_update_cosine``, ``mean_offdiag``, ``sparsity_fraction`` and
``effective_rank``, ``core/stacking.py::unstack_client_tree`` and
``utils/pytree.py::tree_dot``.

Bounds: counts (the entries the sparsity fraction counts, effective rank)
and the picked client's leaves are equal; float32 results that sum in
other orders (cosines, the off-diagonal mean, the tree dot, the sparsity
fraction's mean) within 1e-6 of their largest magnitude.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import metrics as jmetrics
from repro.core import stacking as jstacking
from repro.utils import pytree as jpytree
from repro_torch.core import metrics, stacking
from repro_torch.utils import pytree


def stacked_tree(rng, clients=5):
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    return {"attn": {"a": f(clients, 4, 3), "b": f(clients, 3, 6)}, "mlp": f(clients, 7)}


def both(tree):
    """The same nested dict as numpy-backed torch and jnp leaves."""
    if isinstance(tree, dict):
        pairs = {k: both(v) for k, v in tree.items()}
        return {k: p[0] for k, p in pairs.items()}, {k: p[1] for k, p in pairs.items()}
    return torch.from_numpy(tree.copy()), jnp.asarray(tree)


def close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6 * max(np.abs(want).max(), 1))


def case_client_update_cosine(rng):
    t, j = both(stacked_tree(rng))
    close(metrics.client_update_cosine(t), jmetrics.client_update_cosine(j))


def case_mean_offdiag(rng):
    sim = rng.uniform(-1, 1, size=(6, 6)).astype(np.float32)
    close(metrics.mean_offdiag(torch.from_numpy(sim)), jmetrics.mean_offdiag(jnp.asarray(sim)))
    one = np.ones((1, 1), np.float32)  # no off-diagonal entry: 0 / max(0, 1)
    close(metrics.mean_offdiag(torch.from_numpy(one)), jmetrics.mean_offdiag(jnp.asarray(one)))


def case_sparsity_fraction(rng):
    x = rng.normal(size=(40, 25)).astype(np.float32)
    x[rng.random(x.shape) < 0.3] = 0.0
    x[rng.random(x.shape) < 0.1] *= 1e-7  # relatively zero at 1e-6, not at 1e-8
    for tol in (1e-6, 1e-8, 0.5):
        got = float(metrics.sparsity_fraction(torch.from_numpy(x), tol))
        want = float(jmetrics.sparsity_fraction(jnp.asarray(x), tol))
        # The same count of (relatively) zero entries; the float32 means may
        # round a last bit apart.
        assert round(got * x.size) == round(want * x.size)
        assert got == pytest.approx(want, rel=1e-6, abs=0)


def case_effective_rank(rng):
    low = rng.normal(size=(30, 3)) @ rng.normal(size=(3, 12))
    x = (low + 1e-5 * rng.normal(size=low.shape)).astype(np.float32)
    for tol in (1e-3, 1e-8):
        got = metrics.effective_rank(torch.from_numpy(x), tol)
        assert int(got) == int(jmetrics.effective_rank(jnp.asarray(x), tol))
    assert int(metrics.effective_rank(torch.from_numpy(x))) == 3


def case_unstack_client_tree(rng):
    t, j = both(stacked_tree(rng))
    for i in (0, 3):
        got = pytree.tree_leaves(stacking.unstack_client_tree(t, i))
        want = jax.tree_util.tree_leaves(jstacking.unstack_client_tree(j, i))
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))


def case_tree_dot(rng):
    (ta, ja), (tb, jb) = both(stacked_tree(rng)), both(stacked_tree(rng))
    close(pytree.tree_dot(ta, tb), jpytree.tree_dot(ja, jb))


CASES = {f.__name__.removeprefix("case_"): f for f in (
    case_client_update_cosine, case_mean_offdiag, case_sparsity_fraction, case_effective_rank,
    case_unstack_client_tree, case_tree_dot)}


@pytest.mark.parametrize("name", sorted(CASES))
def test_mirror_matches_jax(name):
    CASES[name](np.random.default_rng(sorted(CASES).index(name)))
