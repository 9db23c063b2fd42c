"""Port mesh-sharded aggregation against the JAX package, on CPU meshes.

The reference's sharded path is held to its unsharded path by its own
suite (``tests/test_mesh_agg.py``, which needs 4 forced host devices and
skips in a single-device run), so the reference here is JAX's UNSHARDED
result.  Inputs are planted (a rank-2 core plus sparse spikes, the shapes of
``tests/test_mesh_agg.py``) so that both packages take the same fallback
branches of the subspace SVT; the fallback counts are held equal.

Tolerances:
  * the factored tail's plain version against the JAX oracle and the Pallas
    kernel (interpret mode): L, S', Y' atol 1e-6 times the largest input
    (fp32 values, an r-term product and a few elementwise ops each); the
    residual sums 1e-5 of their largest entry (fp32 sums over ~10^2 terms in
    another order), as ``tests/test_torch_kernels.py`` holds sums;
  * the sharded RPCA against JAX's unsharded RPCA: atol = rtol = 1e-5, the
    reference's own shard-invariance bound (test_mesh_agg.py:226); the same
    bound across shard counts inside the port;
  * the sharded ``aggregate`` against JAX's: atol 1e-5 times max |delta|, the
    bound of ``tests/test_torch_engine.py``;
  * ``run_simulation``: the bounds of ``tests/test_torch_round.py``.
Inside the port, a one-shard mesh and ``mesh_overlap`` are held bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.core import aggregate as jaggregate
from repro.core import rpca as jrpca
from repro.kernels import ref as jref
from repro.kernels import svt_subspace as jsub
from repro_torch.convert import from_jax_tree
from repro_torch.core import AggregatorConfig, aggregate, rpca
from repro_torch.kernels import ref, svt_subspace
from repro_torch.launch.mesh import (
    ClientMesh,
    client_shard_count,
    make_debug_mesh,
    make_host_mesh,
)
from repro_torch.utils.pytree import tree_leaves

SHARD_TOL = dict(atol=1e-5, rtol=1e-5)


def cpu_mesh(n):
    return make_host_mesh(n, device="cpu")


def planted_bucket(seed, b=2, d=24, nc=8):
    """Low-rank core + sparse spikes (``tests/test_mesh_agg.py``'s bucket)."""
    rng = np.random.default_rng(seed)
    u = rng.normal(size=(b, d, 2))
    w = rng.normal(size=(b, 2, nc))
    sp = np.where(rng.random((b, d, nc)) < 0.05, 5.0 * rng.normal(size=(b, d, nc)), 0.0)
    return (u @ w + sp).astype(np.float32)


def cohort_mask(nc):
    """Two clients of the cohort inactive: the third and the last."""
    mask = np.ones(nc, np.float32)
    mask[[2, nc - 1]] = 0.0
    return mask


def opt(x, conv):
    return None if x is None else conv(x)


def jax_bucket(m, mask=None, **kw):
    """The reference's unsharded result and its fallback count."""
    res, carry = jrpca.robust_pca_bucket(
        jnp.asarray(m), client_mask=opt(mask, jnp.asarray), return_carry=True, **kw
    )
    return res, int(carry.fall_count)


def port_sharded(m, mesh, mask=None, **kw):
    return rpca.robust_pca_bucket_sharded(
        torch.from_numpy(m), mesh=mesh, client_mask=opt(mask, torch.from_numpy), **kw
    )


def assert_result_close(got, want, **tol):
    for g, w in ((got.low_rank, want.low_rank), (got.sparse, want.sparse)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **(tol or SHARD_TOL))


# ---------------------------------------------------------------------------
# The factored tail's plain version
# ---------------------------------------------------------------------------


def factored_inputs(seed, b, vec, d2, r, masked):
    rng = np.random.default_rng(seed)
    t = lambda *s: rng.normal(size=s).astype(np.float32)
    m, y = t(b, vec, d2), 0.3 * t(b, vec, d2)
    f, vr = t(b, vec, r), t(b, d2, r) / np.sqrt(d2)
    rho = (0.5 + rng.random(b)).astype(np.float32)
    mask = None
    if masked:
        mask = cohort_mask(d2)
        m = m * mask
    return dict(m=m, y=y, f=f, vr=vr, rho=rho, mu=1.0 / rho, th=0.4 * rho, mask=mask)


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("r", [1, 3, 8])
@pytest.mark.parametrize("vec", [32, 37])  # a multiple of block_vec=16, and not
def test_factored_plain_matches_jax(vec, r, masked):
    x = factored_inputs(vec + r, 3, vec, 10, r, masked)
    args = [x[k] for k in ("m", "y", "f", "vr", "rho", "mu", "th")]
    got = svt_subspace.subspace_apply_factored(
        *(torch.from_numpy(np.array(a)) for a in args), mask=opt(x["mask"], torch.from_numpy)
    )
    jargs = [jnp.asarray(a) for a in args]
    jmask = opt(x["mask"], jnp.asarray)
    want_ref = jref.svt_subspace_apply_factored_ref(*jargs, mask=jmask)
    want_pallas = jsub.subspace_apply_factored(
        *jargs, mask=jmask, block_vec=16, interpret=True
    )
    tol = 1e-6 * max(np.abs(a).max() for a in args)
    for want in (want_ref, want_pallas):
        for g, w in zip(got[:3], want[:3]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=tol)
        rsq = np.asarray(want[3], np.float64)
        np.testing.assert_allclose(got[3].numpy(), rsq, rtol=0, atol=1e-5 * np.abs(rsq).max())
    if masked:  # S' and Y' exactly zero in masked columns
        dead = x["mask"] == 0
        assert np.all(got[1].numpy()[..., dead] == 0) and np.all(got[2].numpy()[..., dead] == 0)
    else:  # mask=None is the bits of an all-ones mask
        ones = svt_subspace.subspace_apply_factored(
            *(torch.from_numpy(np.array(a)) for a in args), mask=torch.ones(10)
        )
        assert all(torch.equal(a, b) for a, b in zip(got, ones))


def test_factored_plain_is_the_ref_and_checks_shapes():
    x = factored_inputs(0, 2, 20, 5, 3, True)
    t = {k: torch.from_numpy(np.array(v)) for k, v in x.items()}
    args = [t[k] for k in ("m", "y", "f", "vr", "rho", "mu", "th")]
    got = svt_subspace.subspace_apply_factored(*args, mask=t["mask"])
    want = ref.svt_subspace_apply_factored_ref(*args, mask=t["mask"])
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    bad = dict(f=t["f"][:, :, :2], vr=t["vr"][:, :4], y=t["y"][:, :7], rho=t["rho"][:1])
    for name, value in bad.items():
        kw = dict(zip(("m", "y", "f", "vr", "rho", "mu", "th"), args), **{name: value})
        with pytest.raises(ValueError):
            svt_subspace.subspace_apply_factored(
                kw["m"], kw["y"], kw["f"], kw["vr"], kw["rho"], kw["mu"], kw["th"]
            )


# ---------------------------------------------------------------------------
# robust_pca_bucket_sharded against JAX's unsharded robust_pca_bucket
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
@pytest.mark.parametrize("shards", [2, 3, 4])
def test_sharded_matches_jax_unsharded(shards, svt_mode, masked):
    nc = 12
    m = planted_bucket(shards, b=3, d=32, nc=nc)
    mask = cohort_mask(nc) if masked else None
    want, falls = jax_bucket(m, mask, n_iter=20, svt_mode=svt_mode)
    got = port_sharded(m, cpu_mesh(shards), mask, n_iter=20, svt_mode=svt_mode)
    assert_result_close(got, want)
    assert got.n_fallback == falls
    if svt_mode == "subspace":
        assert 0 < falls < 20  # the Ritz path ran too
    if masked:  # masked output columns exactly zero
        dead = mask == 0
        assert np.all(got.low_rank.numpy()[..., dead] == 0)
        assert np.all(got.sparse.numpy()[..., dead] == 0)


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
@pytest.mark.parametrize("nc", [9, 10])
def test_sharded_ragged_matches_jax_unsharded(nc, svt_mode):
    """9 and 10 clients on 4 shards: padded to 12 with zero-mask columns,
    sliced back to nc on exit; the rank cap keeps the true cohort."""
    m = planted_bucket(nc, b=2, d=24, nc=nc)
    want, falls = jax_bucket(m, n_iter=20, svt_mode=svt_mode)
    got = port_sharded(m, cpu_mesh(4), n_iter=20, svt_mode=svt_mode)
    assert got.low_rank.shape == m.shape and got.sparse.shape == m.shape
    assert_result_close(got, want)
    assert got.n_fallback == falls


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_sharded_tol_loop_matches_jax_unsharded(svt_mode):
    """The tolerance loop reads a psum'd residual: the per-module iteration
    counts are a sharp probe, and must be equal."""
    m = planted_bucket(7, b=3, d=32, nc=8)
    want, falls = jax_bucket(m, n_iter=50, tol=2e-3, svt_mode=svt_mode)
    for shards in (2, 4):
        got = port_sharded(m, cpu_mesh(shards), n_iter=50, tol=2e-3, svt_mode=svt_mode)
        np.testing.assert_array_equal(got.n_iter.numpy(), np.asarray(want.n_iter))
        assert int(got.n_iter.min()) < 50
        assert_result_close(got, want)
        assert got.n_fallback == falls


def test_padded_columns_contribute_zero():
    """What lies behind a zero mask is unobservable: 1e3-scaled garbage in a
    masked column decomposes bit for bit as zeros do, and the column comes
    out exactly zero."""
    m7 = planted_bucket(3, b=2, d=24, nc=7)
    zeros = np.zeros((2, 24, 1), np.float32)
    garbage = 1e3 * np.random.default_rng(0).normal(size=(2, 24, 1)).astype(np.float32)
    mask = np.asarray([1, 1, 1, 1, 1, 1, 1, 0], np.float32)
    kw = dict(n_iter=20, svt_mode="subspace")
    ref_ = port_sharded(np.concatenate([m7, zeros], -1), cpu_mesh(4), mask, **kw)
    got = port_sharded(np.concatenate([m7, garbage], -1), cpu_mesh(4), mask, **kw)
    assert torch.equal(ref_.low_rank, got.low_rank) and torch.equal(ref_.sparse, got.sparse)
    assert torch.all(got.low_rank[..., 7:] == 0) and torch.all(got.sparse[..., 7:] == 0)


# ---------------------------------------------------------------------------
# Inside the port, port against port
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_one_shard_mesh_is_the_unsharded_call_bitwise(svt_mode):
    m = torch.from_numpy(planted_bucket(1))
    want = rpca.robust_pca_bucket(m, n_iter=15, svt_mode=svt_mode)
    for mesh in (None, make_debug_mesh("cpu"), cpu_mesh(1)):
        got = rpca.robust_pca_bucket_sharded(m, mesh=mesh, n_iter=15, svt_mode=svt_mode)
        assert torch.equal(got.low_rank, want.low_rank) and torch.equal(got.sparse, want.sparse)
    tree = from_jax_tree(planted_tree(2, 8))
    cfg = AggregatorConfig(method="fedrpca", rpca_iters=10, svt_mode=svt_mode)
    base = aggregate(tree, cfg, device="cpu")
    for mesh in (make_debug_mesh("cpu"), cpu_mesh(1)):
        got = aggregate(tree, cfg, mesh=mesh, device="cpu")
        assert all(torch.equal(a, b) for a, b in zip(tree_leaves(got), tree_leaves(base)))


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_mesh_overlap_is_bitwise_noop(svt_mode):
    m = planted_bucket(4, b=6, d=32, nc=8)
    off = port_sharded(m, cpu_mesh(4), n_iter=20, svt_mode=svt_mode)
    on = port_sharded(m, cpu_mesh(4), n_iter=20, svt_mode=svt_mode, mesh_overlap=True)
    assert torch.equal(off.low_rank, on.low_rank) and torch.equal(off.sparse, on.sparse)
    assert off.n_fallback == on.n_fallback


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_shard_counts_agree(svt_mode):
    m = planted_bucket(5, b=3, d=32, nc=8)
    one = port_sharded(m, None, n_iter=20, svt_mode=svt_mode)
    for shards in (2, 4):
        got = port_sharded(m, cpu_mesh(shards), n_iter=20, svt_mode=svt_mode)
        for g, w in ((got.low_rank, one.low_rank), (got.sparse, one.sparse)):
            np.testing.assert_allclose(g.numpy(), w.numpy(), **SHARD_TOL)
        assert got.n_fallback == one.n_fallback


def test_mesh_helpers():
    mesh = cpu_mesh(3)
    assert isinstance(mesh, ClientMesh) and mesh.devices == (torch.device("cpu"),) * 3
    assert [client_shard_count(x) for x in (None, make_debug_mesh("cpu"), mesh)] == [1, 1, 3]
    assert rpca.mesh_client_shards(mesh) == 3
    assert rpca.CLIENT_AXIS_NAMES == jrpca.CLIENT_AXIS_NAMES
    parts = [torch.full((2,), float(k + 1)) for k in range(3)]
    assert all(torch.equal(p, torch.full((2,), 6.0)) for p in mesh.psum(parts))
    assert torch.equal(mesh.all_gather(parts, 0), torch.tensor([1.0, 1, 2, 2, 3, 3]))
    with pytest.raises(ValueError):
        make_host_mesh(0, device="cpu")


def test_make_host_mesh_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_host_mesh(2)
    assert cpu_mesh(2).shards == 2


# ---------------------------------------------------------------------------
# aggregate(engine="packed", mesh=...) against JAX's aggregate
# ---------------------------------------------------------------------------


def planted_tree(seed, nc, rank=2):
    """Stacked deltas shaped as ``tests/test_mesh_agg.py``'s tree, with an
    (A, B) adapter pair for ``joint_ab``; each module a low-rank client core
    plus sparse spikes."""
    rng = np.random.default_rng(seed)

    def mk(*s):
        vec = int(np.prod(s[1:]))
        low = rng.normal(size=(vec, rank)) @ rng.normal(size=(rank, nc))
        sp = np.where(rng.random((vec, nc)) < 0.05, 5.0 * rng.normal(size=(vec, nc)), 0.0)
        return np.moveaxis(low + sp, -1, 0).reshape(s).astype(np.float32)

    return {"A": mk(nc, 4, 6, 8), "head": mk(nc, 12, 4),
            "attn": {"A": mk(nc, 2, 8, 4), "B": mk(nc, 2, 4, 8)}}


AGG_CASES = [
    ("fedavg", {}), ("task_arithmetic", {}),
    ("fedrpca", dict(svt_mode="gram")), ("fedrpca", dict(svt_mode="subspace")),
]


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("method,extra", AGG_CASES, ids=lambda v: str(v))
def test_aggregate_on_mesh_matches_jax(method, extra, masked):
    nc = 8
    tree = planted_tree(6, nc)
    mask = np.asarray([1, 1, 0, 1, 1, 1, 0, 1], np.float32) if masked else None
    kw = dict(method=method, rpca_iters=10, **extra)
    want = jaggregate(jax.tree_util.tree_map(jnp.asarray, tree), JConfig(**kw),
                      mask=opt(mask, jnp.asarray))
    got = aggregate(from_jax_tree(tree), AggregatorConfig(**kw), engine="packed",
                    mask=opt(mask, torch.from_numpy), mesh=cpu_mesh(4), device="cpu")
    assert_tree_close(got, want, tree)


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_aggregate_joint_ab_on_mesh_matches_jax(svt_mode):
    tree = planted_tree(8, 8)
    kw = dict(method="fedrpca", rpca_iters=10, joint_ab=True, svt_mode=svt_mode)
    want = jaggregate(jax.tree_util.tree_map(jnp.asarray, tree), JConfig(**kw))
    got = aggregate(from_jax_tree(tree), AggregatorConfig(**kw), mesh=cpu_mesh(4), device="cpu")
    assert_tree_close(got, want, tree)


def assert_tree_close(got, want, tree):
    scale = max(np.abs(x).max() for x in jax.tree_util.tree_leaves(tree))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(
            np.asarray(g, np.float64), np.asarray(w, np.float64), rtol=0, atol=1e-5 * scale
        )


def test_reference_engine_refuses_a_mesh():
    tree = from_jax_tree(planted_tree(0, 8))
    with pytest.raises(ValueError, match="reference engine"):
        aggregate(tree, AggregatorConfig(method="fedrpca"), engine="reference",
                  mesh=cpu_mesh(2), device="cpu")
    # A one-shard mesh is ignored by both engines.
    aggregate(tree, AggregatorConfig(method="fedavg"), engine="reference",
              mesh=make_debug_mesh("cpu"), device="cpu")


# ---------------------------------------------------------------------------
# run_simulation(mesh_shards=2) against JAX's unsharded run
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
def test_run_simulation_on_mesh_matches_jax(svt_mode):
    from test_torch_round import LOCAL, TASK, jax_batch_indices, port_local

    from repro.fed import FedRunConfig as JRun
    from repro.fed import LocalSpec as JLocal
    from repro.fed import run_simulation as jrun
    from repro.fed import synth as jsynth
    from repro.optim import make_optimizer as jopt
    from repro_torch.fed import FedRunConfig, run_simulation, synth

    rounds = 2
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    lora0 = jsynth.init_lora(jtask, seed=0)
    agg = dict(method="fedrpca", rpca_iters=10, svt_mode=svt_mode)
    jcfg = JRun(
        aggregator=JConfig(**agg), rounds=rounds, seed=0,
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
                        rounds=rounds, seed=0, mesh_shards=2)
    teval = lambda l: synth.accuracy(ttask.base, l, ttask.test_x, ttask.test_y, ttask.lora_scale)
    tlora, thist = run_simulation(
        ttask.base, from_jax_tree(lora0), ttask.client_x, ttask.client_y, tcfg, teval,
        batch_indices=lambda r: idx[r], device="cpu",
    )
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(thist, jhist, atol=2.0 / TASK["n_test"] + 1e-9)


def test_reference_engine_with_mesh_shards_warns_and_runs_unsharded():
    from test_torch_round import LOCAL, TASK, port_local

    from repro_torch.fed import FedRunConfig, run_simulation, synth

    task = synth.make_synth_task(**TASK)
    runs = {}
    for shards in (0, 2):
        cfg = FedRunConfig(aggregator=AggregatorConfig(method="fedrpca", rpca_iters=5),
                           local=port_local(task, **LOCAL), rounds=1, engine="reference",
                           mesh_shards=shards)
        if shards:
            with pytest.warns(UserWarning, match="replicated"):
                runs[shards] = run_simulation(task.base, synth.init_lora(task), task.client_x,
                                              task.client_y, cfg, lambda l: 0.0, device="cpu")
        else:
            runs[shards] = run_simulation(task.base, synth.init_lora(task), task.client_x,
                                          task.client_y, cfg, lambda l: 0.0, device="cpu")
    for a, b in zip(tree_leaves(runs[0][0]), tree_leaves(runs[2][0])):
        assert torch.equal(a, b)
