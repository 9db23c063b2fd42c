"""Port cross-round aggregation sessions against the JAX package: bucket
carries (warm and cold, gram and subspace, masked, tolerance loop), the
per-matrix drivers' carries, sharded carries on CPU meshes, the session API
(``AggSession``, ``aggregate_planned``, ``plan_retier``, ``migrate_carry``)
and carrying server rounds.

Inputs are the reference suite's (``tests/test_agg_session.py``'s
``round_sequence`` and its correlated bucket rounds, ``tests/test_mesh_agg.py``'s
warm sharded cases), made with numpy and fed to both packages.  Tolerances:
L and S atol 1e-4 * max|M| (fp32 eigh and matmul round-off over the ADMM
iterations, as ``tests/test_torch_rpca.py``); session updates atol
1e-4 * max|delta|; iteration, fallback and hit counts exactly equal, round by
round.  The reference's bitwise contracts are pinned port against port:
an invalid carry is the carry-less call, ``carry_mode="none"`` and a
non-fedrpca session are the stateless call.  The reference's "zero extra
compiles" becomes: the plan is built once, and the carry keeps its shapes,
dtypes and device from round to round.
"""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.core import AggSession as JSession
from repro.core import aggregate_planned as jplanned
from repro.core import init_agg_carry as jinit_agg
from repro.core import migrate_carry as jmigrate
from repro.core import plan_aggregation as jplan
from repro.core import plan_retier as jretier
from repro.core import rpca as jrpca
from repro_torch.convert import from_jax_tree
from repro_torch.core import (
    AggregatorConfig,
    AggSession,
    aggregate,
    aggregate_planned,
    init_agg_carry,
    migrate_carry,
    plan_aggregation,
    plan_retier,
    rpca,
)
from repro_torch.launch.mesh import make_host_mesh
from repro_torch.utils.pytree import tree_leaves

TOL = 1e-4


def round_sequence(seed, nc, rounds, drift=0.02, rank=2):
    """``tests/test_agg_session.py::round_sequence`` in numpy: a drifting
    shared low-rank core plus persistent per-client sparse spikes."""
    rng = np.random.default_rng(seed)
    shapes = {"A": (4, 6, 8), "B": (4, 8, 6), "head": (12, 4), "odd": (5, 10)}
    cores, spikes = {}, {}
    for k, s in shapes.items():
        d = int(np.prod(s))
        cores[k] = (rng.normal(size=(d, rank)), rng.normal(size=(rank, nc)))
        spikes[k] = np.where(rng.random((d, nc)) < 0.05, 5.0 * rng.normal(size=(d, nc)), 0.0)
    out = []
    for _ in range(rounds):
        lv = {}
        for k, s in shapes.items():
            u, w = cores[k]
            w_t = w + drift * rng.normal(size=w.shape)
            sp_t = spikes[k] * (1.0 + 0.05 * rng.normal(size=spikes[k].shape))
            lv[k] = (u @ w_t + sp_t).T.reshape(nc, *s).astype(np.float32)
        out.append({"blocks": {"attn": {"A": lv["A"], "B": lv["B"]}},
                    "head": lv["head"], "odd": lv["odd"]})
    return out


def bucket_rounds(seed, d=64, nc=16, rounds=4):
    """``TestBucketCarry._rounds``: one (1, d, nc) bucket a round, a
    rank-2 core drifting with the round index plus fixed spikes."""
    rng = np.random.default_rng(seed)
    u, w = rng.normal(size=(d, 2)), rng.normal(size=(2, nc))
    sp = np.where(rng.random((d, nc)) < 0.05, 5.0 * rng.normal(size=(d, nc)), 0.0)
    return [(u @ (w + 0.02 * t * rng.normal(size=w.shape)) + sp)[None].astype(np.float32)
            for t in range(rounds)]


def session_kw(**kw):
    base = dict(method="fedrpca", rpca_iters=60, rpca_fixed_iters=False, rpca_tol=1e-5,
                svt_mode="subspace", carry_mode="subspace")
    base.update(kw)
    return base


def cpu_carry(b, vec, d2, rank=8, true_cols=None):
    return rpca.init_bucket_carry(b, vec, d2, rank, true_cols, device="cpu")


def close(got, want, scale):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=0, atol=TOL * scale)


def assert_tree_close(got, want, scale):
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        close(g.detach().cpu().numpy(), w, scale)


def tree_scale(tree):
    return max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(tree))


def opt(x, conv):
    return None if x is None else conv(x)


# ---------------------------------------------------------------------------
# Bucket carries against the reference, round by round
# ---------------------------------------------------------------------------


def run_bucket_rounds(ms, mode, tol, n_iter, mask=None, port_rpca=None):
    """Both packages' carried rounds: per round (port result, port carry,
    reference result, reference carry)."""
    port_rpca = port_rpca or rpca.robust_pca_bucket
    nc = ms[0].shape[-1]
    jc = jrpca.init_bucket_carry(1, 64, nc, 8)
    tc = cpu_carry(1, 64, nc)
    out = []
    for m in ms:
        kw = dict(n_iter=n_iter, tol=tol, svt_mode=mode)
        jres, jc = jrpca.robust_pca_bucket(jnp.asarray(m), client_mask=opt(mask, jnp.asarray),
                                           carry=jc, return_carry=True, **kw)
        tres, tc = port_rpca(torch.from_numpy(m), client_mask=opt(mask, torch.from_numpy),
                             carry=tc, return_carry=True, **kw)
        out.append((tres, tc, jres, jc))
    return out


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("svt_mode,tol", [("subspace", 1e-5), ("subspace", None),
                                          ("gram", 1e-5), ("gram", None)])
def test_warm_bucket_rounds_match_jax(svt_mode, tol, masked):
    nc = 8 if masked else 16
    mask = (np.arange(nc) < 5).astype(np.float32) if masked else None
    ms = bucket_rounds(0, nc=nc)  # the reference suite's own rounds
    rounds = run_bucket_rounds(ms, svt_mode, tol, 100 if tol else 30, mask)
    for i, ((tres, tc, jres, jc), m) in enumerate(zip(rounds, ms)):
        scale = float(np.abs(m).max())
        close(tres.low_rank.numpy(), jres.low_rank, scale)
        close(tres.sparse.numpy(), jres.sparse, scale)
        close(tc.y.numpy(), jc.y, scale)
        np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
        assert int(tc.fall_count) == int(jc.fall_count) == tres.n_fallback, i
        assert float(tc.hit) == float(jc.hit) == (0.0 if i == 0 else 1.0)
        assert float(tc.n_eff) == float(jc.n_eff) and bool(tc.valid)
        np.testing.assert_array_equal(tc.n_live.numpy(), np.asarray(jc.n_live))
        if masked:  # padded slots stay exactly zero through the carried rounds
            assert not tres.low_rank[..., 5:].any() and not tres.sparse[..., 5:].any()
    if svt_mode == "subspace":
        assert int(rounds[0][1].fall_count) > 0
        assert all(int(r[1].fall_count) == 0 for r in rounds[1:])
    if tol is not None and not masked:  # warm rounds converge in fewer iterations
        assert all(int(r[0].n_iter[0]) < int(rounds[0][0].n_iter[0]) for r in rounds[1:])


@pytest.mark.parametrize("svt_mode", ["gram", "subspace"])
@pytest.mark.parametrize("masked", [False, True])
def test_invalid_carry_is_bitwise_cold(svt_mode, masked):
    """A rejected carry runs the carry-less program: the same bits."""
    m = torch.from_numpy(bucket_rounds(2, rounds=1)[0])
    mask = (torch.arange(16) < 12).float() if masked else None
    kw = dict(n_iter=40, svt_mode=svt_mode, client_mask=mask)
    with_c, new = rpca.robust_pca_bucket(m, carry=cpu_carry(1, 64, 16), return_carry=True, **kw)
    without = rpca.robust_pca_bucket(m, **kw)
    assert torch.equal(with_c.low_rank, without.low_rank)
    assert torch.equal(with_c.sparse, without.sparse)
    assert float(new.hit) == 0.0 and bool(new.valid)


def test_cohort_change_invalidates():
    """n_eff is the cohort fingerprint: a resized cohort cold-starts, bit for
    bit the carry-less call, as in the reference."""
    ms = bucket_rounds(3, nc=8, rounds=2)
    mask5 = np.asarray([1, 1, 1, 1, 1, 0, 0, 0], np.float32)
    mask6 = np.asarray([1, 1, 1, 1, 1, 1, 0, 0], np.float32)
    kw = dict(n_iter=50, tol=1e-5, svt_mode="subspace")
    _, tc = rpca.robust_pca_bucket(torch.from_numpy(ms[0]), client_mask=torch.from_numpy(mask5),
                                   carry=cpu_carry(1, 64, 8), return_carry=True, **kw)
    _, jc = jrpca.robust_pca_bucket(jnp.asarray(ms[0]), client_mask=jnp.asarray(mask5),
                                    carry=jrpca.init_bucket_carry(1, 64, 8, 8),
                                    return_carry=True, **kw)
    assert float(tc.n_eff) == float(jc.n_eff) == 5.0
    res, tc2 = rpca.robust_pca_bucket(torch.from_numpy(ms[1]), client_mask=torch.from_numpy(mask6),
                                      carry=tc, return_carry=True, **kw)
    _, jc2 = jrpca.robust_pca_bucket(jnp.asarray(ms[1]), client_mask=jnp.asarray(mask6),
                                     carry=jc, return_carry=True, **kw)
    assert float(tc2.hit) == float(jc2.hit) == 0.0
    assert int(tc2.fall_count) == int(jc2.fall_count)
    cold = rpca.robust_pca_bucket(torch.from_numpy(ms[1]), client_mask=torch.from_numpy(mask6), **kw)
    assert torch.equal(res.low_rank, cold.low_rank) and torch.equal(res.sparse, cold.sparse)


def test_carry_gate_rejects_a_worse_start():
    """``carry_gate`` below 1 can refuse a valid carry whose initial residual
    exceeds it; the reference decides the same."""
    ms = bucket_rounds(4, rounds=2)
    kw = dict(n_iter=30, svt_mode="subspace")
    _, tc = rpca.robust_pca_bucket(torch.from_numpy(ms[0]), carry=cpu_carry(1, 64, 16),
                                   return_carry=True, **kw)
    _, jc = jrpca.robust_pca_bucket(jnp.asarray(ms[0]), carry=jrpca.init_bucket_carry(1, 64, 16, 8),
                                    return_carry=True, **kw)
    for gate in (1.0, 1e-9):
        _, t2 = rpca.robust_pca_bucket(torch.from_numpy(ms[1]), carry=tc, return_carry=True,
                                       carry_gate=gate, **kw)
        _, j2 = jrpca.robust_pca_bucket(jnp.asarray(ms[1]), carry=jc, return_carry=True,
                                        carry_gate=gate, **kw)
        assert float(t2.hit) == float(j2.hit) == (1.0 if gate == 1.0 else 0.0)


@pytest.mark.parametrize("what", ["rows", "basis"])
def test_carry_shape_mismatch_rejected(what):
    m = torch.from_numpy(bucket_rounds(5, rounds=1)[0])
    bad = cpu_carry(1, 32, 16) if what == "rows" else cpu_carry(1, 64, 16, rank=3)
    with pytest.raises(ValueError, match="carry shape" if what == "rows" else "basis"):
        rpca.robust_pca_bucket(m, svt_mode="subspace", carry=bad, return_carry=True)
    with pytest.raises(ValueError, match="carry"):
        rpca.robust_pca_bucket_sharded(m, mesh=make_host_mesh(2, "cpu"), svt_mode="subspace",
                                       carry=bad, return_carry=True)


@pytest.mark.parametrize("svt_mode", ["subspace", "gram"])
@pytest.mark.parametrize("driver", ["tol", "fixed"])
def test_per_matrix_drivers_carry_like_jax(svt_mode, driver):
    """robust_pca / robust_pca_fixed_iters thread a B=1 carry through the
    bucket loop in either mode, with the reference's counts."""
    ms = [m[0] for m in bucket_rounds(6, rounds=2)]
    tc, jc = cpu_carry(1, 64, 16), jrpca.init_bucket_carry(1, 64, 16, 8)
    for m in ms:
        if driver == "tol":
            kw = dict(max_iter=60, tol=1e-5, svt_mode=svt_mode, return_carry=True)
            tres, tc = rpca.robust_pca(torch.from_numpy(m), carry=tc, **kw)
            jres, jc = jrpca.robust_pca(jnp.asarray(m), carry=jc, **kw)
        else:
            kw = dict(n_iter=20, svt_mode=svt_mode, return_carry=True)
            tres, tc = rpca.robust_pca_fixed_iters(torch.from_numpy(m), carry=tc, **kw)
            jres, jc = jrpca.robust_pca_fixed_iters(jnp.asarray(m), carry=jc, **kw)
        assert tres.low_rank.shape == m.shape
        close(tres.low_rank.numpy(), jres.low_rank, float(np.abs(m).max()))
        assert int(tres.n_iter) == int(jres.n_iter)
        assert int(tc.fall_count) == int(jc.fall_count)
    assert float(tc.hit) == float(jc.hit) == 1.0


# ---------------------------------------------------------------------------
# Sharded carries on CPU meshes against the reference's unsharded carries
# ---------------------------------------------------------------------------


def sharded(shards):
    mesh = make_host_mesh(shards, "cpu")
    return functools.partial(rpca.robust_pca_bucket_sharded, mesh=mesh)


@pytest.mark.parametrize("shards,nc,masked", [(2, 16, False), (4, 16, True), (4, 9, False),
                                              (3, 8, True)])
@pytest.mark.parametrize("svt_mode", ["subspace", "gram"])
def test_sharded_bucket_carry_matches_jax(shards, nc, masked, svt_mode):
    """L, S, Y split by client columns and v by basis rows, the ragged
    cohorts (9 on 4 shards, 8 on 3) padded and sliced back: each round's
    result, counts and carry match the reference's unsharded ones.  The
    tolerance loop stops at 1e-4: sharded residual sums add in another
    order, and at 1e-5 their round-off is a few tenths of a percent of the
    residual, enough to move a crossing by one iteration."""
    mask = None
    if masked:
        mask = np.ones(nc, np.float32)
        mask[[1, nc - 1]] = 0.0
    ms = bucket_rounds(7, nc=nc)
    rounds = run_bucket_rounds(ms, svt_mode, 1e-4, 80, mask, port_rpca=sharded(shards))
    for (tres, tc, jres, jc), m in zip(rounds, ms):
        scale = float(np.abs(m).max())
        assert tres.low_rank.shape == m.shape and tc.l.shape == m.shape
        assert tc.v.shape == tuple(jc.v.shape)
        close(tres.low_rank.numpy(), jres.low_rank, scale)
        close(tres.sparse.numpy(), jres.sparse, scale)
        close(tc.y.numpy(), jc.y, scale)
        np.testing.assert_array_equal(tres.n_iter.numpy(), np.asarray(jres.n_iter))
        assert int(tc.fall_count) == int(jc.fall_count)
        assert float(tc.hit) == float(jc.hit)
        if masked:
            dead = mask == 0
            assert not tres.low_rank[..., dead].any() and not tc.y[..., dead].any()
    assert [float(r[1].hit) for r in rounds] == [0.0, 1.0, 1.0, 1.0]


def test_sharded_carry_padded_slots_stay_inert():
    """Garbage in the masked columns of a carry is re-masked on load: the
    warm round is bit for bit the one from a clean carry."""
    ms = bucket_rounds(8, nc=8, rounds=2)
    mask = torch.tensor([1.0] * 6 + [0.0] * 2)
    run = sharded(4)
    kw = dict(n_iter=30, svt_mode="subspace", client_mask=mask, return_carry=True)
    _, c = run(torch.from_numpy(ms[0]), carry=cpu_carry(1, 64, 8), **kw)
    junk = torch.zeros_like(c.l)
    junk[..., 6:] = 1e3
    dirty = c._replace(l=c.l + junk, s=c.s - junk, y=c.y + junk)
    a, _ = run(torch.from_numpy(ms[1]), carry=c, **kw)
    b, cb = run(torch.from_numpy(ms[1]), carry=dirty, **kw)
    assert float(cb.hit) == 1.0
    assert torch.equal(a.low_rank, b.low_rank) and torch.equal(a.sparse, b.sparse)


def port_session_rounds(trees, mesh=None, mask=None, **cfg):
    sess = AggSession(AggregatorConfig(**session_kw(**cfg)), mesh=mesh, device="cpu")
    outs, falls, hits = [], [], []
    for tree in trees:
        out, diag = sess.step(from_jax_tree(tree, "cpu"), mask=opt(mask, torch.from_numpy))
        outs.append(out)
        falls.append(int(diag.scalars["fallback_count"]))
        hits.append(float(diag.scalars["carry_hit_rate"]))
    return outs, falls, hits, sess


@functools.lru_cache(maxsize=None)
def jax_session_rounds(seed, nc, rounds, masked=False, **cfg):
    trees = round_sequence(seed, nc, rounds)
    mask = (np.arange(nc) < nc - 2).astype(np.float32) if masked else None
    sess = JSession(JConfig(**session_kw(**cfg)))
    outs, falls, hits = [], [], []
    for tree in trees:
        out, diag = sess.step(jax.tree_util.tree_map(jnp.asarray, tree),
                              mask=opt(mask, jnp.asarray))
        outs.append(jax.tree_util.tree_map(np.asarray, out))
        falls.append(int(diag.scalars["fallback_count"]))
        hits.append(float(diag.scalars["carry_hit_rate"]))
    tiers = {k: (t.low_idx, t.full_idx, t.low_cap) for k, t in sess.plan.tiers.items()}
    return trees, mask, outs, falls, hits, tiers


@pytest.mark.parametrize("shards,nc", [(1, 8), (2, 8), (4, 8), (2, 9), (4, 9)])
def test_sharded_sessions_match_jax_unsharded(shards, nc):
    """``tests/test_mesh_agg.py``'s warm sharded sessions (8 clients, and the
    ragged 9): the same fallbacks round by round as the reference's
    unsharded session, none after round 0, and the same updates."""
    trees, _, want, jfalls, jhits, _ = jax_session_rounds(10, nc, 4)
    outs, falls, hits, sess = port_session_rounds(trees, mesh=make_host_mesh(shards, "cpu"))
    assert falls == jfalls and hits == jhits
    assert all(f == 0 for f in falls[1:]) and hits[1:] == [1.0, 1.0, 1.0]
    assert (sess.plan.mesh is None) == (shards == 1)
    for got, w, tree in zip(outs, want, trees):
        assert_tree_close(got, w, tree_scale(tree))


# ---------------------------------------------------------------------------
# The session API
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("nc,masked", [(16, False), (32, False), (8, True)])
def test_session_rounds_match_jax(nc, masked):
    """Per-round updates, fallback counts and hit rates equal the
    reference's session; warm rounds take no fallback."""
    trees, mask, want, jfalls, jhits, _ = jax_session_rounds(11, nc, 4, masked)
    outs, falls, hits, _ = port_session_rounds(trees, mask=mask)
    assert falls == jfalls and hits == jhits == [0.0, 1.0, 1.0, 1.0]
    assert falls[0] > 0 and falls[1:] == [0, 0, 0]
    for got, w, tree in zip(outs, want, trees):
        assert_tree_close(got, w, tree_scale(tree))


def test_full_carry_mode_session_matches_jax():
    """carry_mode="full" carries the gram-mode iterates: fewer tolerance
    iterations warm, the reference's updates."""
    trees, _, want, jfalls, jhits, _ = jax_session_rounds(12, 16, 3, svt_mode="gram",
                                                          carry_mode="full")
    outs, falls, hits, _ = port_session_rounds(trees, svt_mode="gram", carry_mode="full")
    assert falls == jfalls == [0, 0, 0] and hits == jhits == [0.0, 1.0, 1.0]
    for got, w, tree in zip(outs, want, trees):
        assert_tree_close(got, w, tree_scale(tree))


def test_session_plan_and_carry_are_stable():
    """The plan is built once; the carry keeps its keys, shapes, dtypes and
    device from round to round."""
    sess = AggSession(AggregatorConfig(**session_kw()), device="cpu")
    plan, layout = None, None
    for tree in round_sequence(13, 8, 4):
        sess.step(from_jax_tree(tree, "cpu"))
        now = {k: [(t.shape, t.dtype, t.device) for t in c] for k, c in sess.carry.items()}
        plan = plan or sess.plan
        layout = layout or now
        assert sess.plan is plan and now == layout
    assert all(bool(c.valid) for c in sess.carry.values())
    sess.reset()  # drops the state: the next round cold-starts
    assert sess.round_idx == 0 and not any(bool(c.valid) for c in sess.carry.values())
    _, diag = sess.step(from_jax_tree(round_sequence(13, 8, 1)[0], "cpu"))
    assert float(diag.scalars["carry_hit_rate"]) == 0.0


def test_carry_mode_none_bitwise_stateless():
    cfg = AggregatorConfig(**session_kw(carry_mode="none"))
    tree = from_jax_tree(round_sequence(14, 8, 1)[0], "cpu")
    sess = AggSession(cfg, device="cpu")
    out, diag = sess.step(tree)
    ref = aggregate(tree, cfg, engine="packed", device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out), tree_leaves(ref)))
    assert sess.carry == {} and "fallback_count" not in diag.scalars


@pytest.mark.parametrize("method", ["dare", "ties", "fedexp", "fedavg", "task_arithmetic"])
def test_non_fedrpca_session_bitwise_stateless(method):
    """Other methods delegate to the stateless call: one dare drop (not
    two), the same bits."""
    tree = from_jax_tree(round_sequence(15, 8, 1)[0], "cpu")
    cfg = AggregatorConfig(method=method, dare_drop=0.5, carry_mode="subspace",
                           svt_mode="subspace")
    out, _ = AggSession(cfg, device="cpu").step(tree, key=5)
    ref = aggregate(tree, cfg, engine="packed", key=5, device="cpu")
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(out), tree_leaves(ref)))


def test_plan_refusals():
    sess = AggSession(AggregatorConfig(**session_kw()), device="cpu")
    sess.step(from_jax_tree(round_sequence(16, 8, 1)[0], "cpu"))
    with pytest.raises(ValueError, match="plan"):
        aggregate_planned(sess.plan, from_jax_tree(round_sequence(16, 16, 1)[0], "cpu"),
                          sess.carry)
    with pytest.raises(ValueError, match="svt_mode"):
        plan_aggregation({"w": torch.zeros((4, 3, 3))},
                         AggregatorConfig(method="fedrpca", carry_mode="subspace"))
    with pytest.raises(ValueError, match="carry_mode"):
        plan_aggregation({"w": torch.zeros((4, 3, 3))},
                         AggregatorConfig(method="fedrpca", carry_mode="warp"))
    # Uplinks and client ranks are ported: a sketch uplink on a plan with no
    # carry warns and plans dense; declared ranks ride on the PackSpec.
    with pytest.warns(UserWarning, match="running dense"):
        assert plan_aggregation({"w": torch.zeros((4, 3, 3))}, AggregatorConfig(),
                                uplink="sketch").uplink is None
    assert plan_aggregation({"w": torch.zeros((4, 3, 3))}, AggregatorConfig(),
                            client_ranks=[2, 1, 2, 1]).spec.client_ranks == (2, 1, 2, 1)
    plan_aggregation({"w": torch.zeros((4, 3, 3))}, AggregatorConfig(), uplink="dense")


def test_session_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        AggSession(AggregatorConfig(**session_kw()))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        rpca.init_bucket_carry(1, 8, 4, 2)


# ---------------------------------------------------------------------------
# Two-tier re-packing
# ---------------------------------------------------------------------------


def both_first_rounds(nc, rounds):
    """The two packages' plans and carries after round 0 of one tree
    sequence."""
    trees = round_sequence(17, nc, rounds)
    cfg = session_kw()
    jt = jax.tree_util.tree_map(jnp.asarray, trees[0])
    jp = jplan(jt, JConfig(**cfg))
    _, jc, _ = jplanned(jp, jt, jinit_agg(jp), with_diagnostics=True)
    tt = from_jax_tree(trees[0], "cpu")
    tp = plan_aggregation(tt, AggregatorConfig(**cfg))
    _, tc, _ = aggregate_planned(tp, tt, init_agg_carry(tp), with_diagnostics=True)
    return trees, (jp, jc), (tp, tc)


def tier_view(plan):
    return {k: (t.low_idx, t.full_idx, t.low_cap) for k, t in plan.tiers.items()}


@pytest.mark.parametrize("margin", [None, 3])
def test_retier_membership_matches_jax(margin):
    _, (jp, jc), (tp, tc) = both_first_rounds(32, 1)
    jnew = jretier(jp, jax.device_get(jc), margin=margin)
    tnew = plan_retier(tp, tc, margin=margin)
    assert tier_view(tnew) == tier_view(jnew)
    if margin is None:  # planted rank 2, cap 8: modules converge low
        assert any(t.low_idx for t in tnew.tiers.values())
    for bkey, t in tnew.tiers.items():
        assert sorted(t.low_idx + t.full_idx) == list(range(tp.spec.bucket_dims[bkey][0]))


def test_tiered_step_matches_untiered_and_jax():
    """Round 1 on the re-tiered plan with the migrated carry: the reference's
    tiered update, the port's untiered one, diagnostics for every module,
    and a warm round 2."""
    trees, (jp, jc), (tp, tc) = both_first_rounds(16, 3)
    jtier = jretier(jp, jax.device_get(jc))
    ttier = plan_retier(tp, tc)
    assert tier_view(ttier) == tier_view(jtier)
    jmig, tmig = jmigrate(jp, jc, jtier), migrate_carry(tp, tc, ttier)
    assert {k: tuple(c.v.shape) for k, c in tmig.items()} == \
        {k: tuple(c.v.shape) for k, c in jmig.items()}
    j1 = jax.tree_util.tree_map(jnp.asarray, trees[1])
    want, _, _ = jplanned(jtier, j1, jmig, with_diagnostics=True)
    t1 = from_jax_tree(trees[1], "cpu")
    got, tmig2, diag = aggregate_planned(ttier, t1, tmig, with_diagnostics=True)
    untiered, _, _ = aggregate_planned(tp, t1, tc, with_diagnostics=True)
    scale = tree_scale(trees[1])
    assert_tree_close(got, want, scale)
    for a, b in zip(tree_leaves(got), tree_leaves(untiered)):
        close(a.numpy(), b.numpy(), scale)
    n_total = sum(d[0] for d in tp.spec.bucket_dims.values())
    assert diag.flat("beta").shape == (n_total,) and diag.flat("live_rank").shape == (n_total,)
    _, _, diag2 = aggregate_planned(ttier, from_jax_tree(trees[2], "cpu"), tmig2,
                                    with_diagnostics=True)
    assert float(diag2.scalars["carry_hit_rate"]) == 1.0


def test_migrate_carry_slices_trailing_basis_columns():
    """A narrower tier keeps the top (trailing) basis columns; a wider one
    pads identity columns in front."""
    _, _, (tp, tc) = both_first_rounds(16, 1)
    tiered = plan_retier(tp, tc)
    mig = migrate_carry(tp, tc, tiered)
    (bkey, tier), = [(k, t) for k, t in tiered.tiers.items() if t.low_idx][:1]
    old = tc[(bkey, "full")]
    low = mig[(bkey, "low")]
    r_new = low.v.shape[-1]
    for row, mod in enumerate(tier.low_idx):
        assert torch.equal(low.v[row], old.v[mod][:, -r_new:])
        assert torch.equal(low.l[row], old.l[mod])
    back = migrate_carry(tiered, mig, tp)[(bkey, "full")]
    r_full = back.v.shape[-1]
    mod = tier.low_idx[0]
    row = tier.low_idx.index(mod)
    assert torch.equal(back.v[mod][:, r_full - r_new:], low.v[row])
    assert torch.equal(back.v[mod][:, :r_full - r_new],
                       torch.eye(back.v.shape[1], r_full - r_new))


def test_session_auto_retier_matches_jax():
    trees, _, want, jfalls, _, jtiers = jax_session_rounds(18, 16, 5, retier_every=2)
    outs, falls, _, sess = port_session_rounds(trees, retier_every=2)
    assert tier_view(sess.plan) == jtiers
    assert any(t.low_idx for t in sess.plan.tiers.values())
    assert falls == jfalls
    for got, w, tree in zip(outs, want, trees):
        assert_tree_close(got, w, tree_scale(tree))


# ---------------------------------------------------------------------------
# Carrying server rounds
# ---------------------------------------------------------------------------

TASK = dict(n_clients=4, n_classes=8, d_in=16, d_feat=16, n_per_client=32, n_test=256,
            lora_rank=2, alpha=0.3, seed=3)
LOCAL = dict(local_steps=4, batch_size=8, lr=1e-2)


def test_run_simulation_with_carry_matches_jax():
    """Two rounds of ``carry_mode="subspace"``: the final LoRA and every
    round's fallback count and hit rate against the reference's carrying
    round (``make_round_fn(lora_template=...)``), on the reference's batch
    indices."""
    from repro.fed import FedRunConfig as JRun
    from repro.fed import LocalSpec as JLocal
    from repro.fed import run_simulation as jrun
    from repro.fed import synth as jsynth
    from repro.optim import make_optimizer as jopt
    from repro_torch.fed import FedRunConfig, LocalSpec, run_simulation, synth
    from repro_torch.optim import make_optimizer
    from test_torch_round import jax_batch_indices

    rounds = 2
    agg = dict(method="fedrpca", rpca_iters=10, svt_mode="subspace", carry_mode="subspace")
    jtask, ttask = jsynth.make_synth_task(**TASK), synth.make_synth_task(**TASK)
    lora0 = jsynth.init_lora(jtask, seed=0)
    jlogs, tlogs = [], []
    jcfg = JRun(aggregator=JConfig(**agg), rounds=rounds, seed=0, local=JLocal(
        loss_fn=lambda b, l, batch: jsynth.loss_fn(b, l, batch, jtask.lora_scale),
        optimizer=jopt("adam", LOCAL["lr"]), **LOCAL))
    jlora, jhist = jrun(jtask.base, lora0, jtask.client_x, jtask.client_y, jcfg,
                        lambda l: 0.0, log_fn=lambda r, d: jlogs.append(d))
    idx = jax_batch_indices(0, rounds, TASK["n_clients"], LOCAL["local_steps"],
                            LOCAL["batch_size"], TASK["n_per_client"])
    local = LocalSpec(loss_fn=lambda b, l, batch: synth.loss_fn(b, l, batch, ttask.lora_scale),
                      optimizer=make_optimizer("adam", LOCAL["lr"]), **LOCAL)
    tcfg = FedRunConfig(aggregator=AggregatorConfig(**agg), local=local, rounds=rounds, seed=0)
    tlora, _ = run_simulation(ttask.base, from_jax_tree(lora0), ttask.client_x, ttask.client_y,
                              tcfg, lambda l: 0.0, log_fn=lambda r, d: tlogs.append(d),
                              batch_indices=lambda r: idx[r], device="cpu")
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    for key in ("fallback_count", "carry_hit_rate", "live_rank_mean"):
        assert [d[key] for d in tlogs] == [float(d[key]) for d in jlogs], key
    assert [d["carry_hit_rate"] for d in tlogs] == [0.0, 1.0]


def test_round_carry_threads_and_needs_a_template():
    from repro_torch.fed import (FedRunConfig, LocalSpec, init_round_state, make_round_fn,
                                 synth)
    from repro_torch.optim import make_optimizer

    task = synth.make_synth_task(**TASK)
    local = LocalSpec(loss_fn=lambda b, l, batch: synth.loss_fn(b, l, batch, task.lora_scale),
                      optimizer=make_optimizer("adam", 1e-2), **LOCAL)
    agg = AggregatorConfig(method="fedrpca", rpca_iters=6, svt_mode="subspace",
                           carry_mode="subspace")
    cfg = FedRunConfig(aggregator=agg, local=local, rounds=1)
    with pytest.raises(ValueError, match="lora_template"):
        make_round_fn(task.base, task.client_x, task.client_y, cfg)
    lora0 = synth.init_lora(task)
    round_fn = make_round_fn(task.base, task.client_x, task.client_y, cfg, lora_template=lora0)
    state = init_round_state(lora0, TASK["n_clients"], 0)
    assert state.agg_carry == () and round_fn.agg_plan is not None
    state, diags = round_fn(state)
    assert state.agg_carry and all(bool(c.valid) for c in state.agg_carry.values())
    assert {"fallback_count", "live_rank_mean", "carry_hit_rate"} <= set(diags)
    carry = state.agg_carry
    state, _ = round_fn(state)
    assert state.agg_carry.keys() == carry.keys()
    # The reference engine is stateless: carry_mode is inert there.
    ref = make_round_fn(task.base, task.client_x, task.client_y,
                        FedRunConfig(aggregator=agg, local=local, rounds=1, engine="reference"))
    state, diags = ref(init_round_state(lora0, TASK["n_clients"], 0))
    assert ref.agg_plan is None and state.agg_carry == () and "fallback_count" not in diags
