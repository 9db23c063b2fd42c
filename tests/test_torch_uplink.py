"""Port compressed uplinks and heterogeneous client ranks against the JAX
package (the cases of ``tests/test_uplink.py``).

The codec runs on the same numpy buckets in both packages: at ``k == d1``
the decode is the input bit for bit in both; below it the coefficients,
shipped values and energy fractions are held to atol 1e-5 (fp32 products
of length d1 <= 40 summed in other orders), the shipped positions exactly
(the inputs are Gaussian, so no two residuals tie).  The engine gate's
bitwise contracts (a dense plan never enters the codec, a cold round and
a zero tolerance are the dense round, a drifted basis trips the gate) are
pinned port against port; sessions and ``run_simulation`` with the sketch
are held to the reference's updates (atol 1e-4 x max|delta|, as
``tests/test_torch_session.py``) and final LoRA (rtol 1e-3 / atol 1e-5, as
``tests/test_torch_round.py``) with equal gate decisions round by round.
The rank masks equal the reference's bit for bit.
"""
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import AggregatorConfig as JConfig
from repro.core import engine as jengine
from repro.core import rpca as jrpca
from repro.core.aggregators import rpca_diag_summary as jsummary
from repro.fed import FedRunConfig as JRun
from repro.fed import LocalSpec as JLocal
from repro.fed import partition as jpartition
from repro.fed import run_simulation as jrun
from repro.fed import sketch as jsketch
from repro.fed import synth as jsynth
from repro.optim import make_optimizer as jopt
from repro_torch.convert import from_jax_tree
from repro_torch.core import AggregatorConfig, AggSession
from repro_torch.core import engine as engine_lib
from repro_torch.core import rpca as rpca_lib
from repro_torch.core.aggregators import rpca_diag_summary
from repro_torch.fed import FedRunConfig, LocalSpec, run_simulation, synth
from repro_torch.fed import partition as partition_lib
from repro_torch.fed import sketch as sketch_lib
from repro_torch.optim import make_optimizer
from repro_torch.utils.pytree import tree_leaves, tree_map

CODEC_ATOL = 1e-5
SESSION_RTOL = 1e-4


def round_trees(seed, nc=8, rounds=4, drift=0.02):
    """``tests/test_uplink.py::round_trees`` in numpy: a drifting shared
    rank-2 core plus persistent sparse spikes."""
    rng = np.random.default_rng(seed)
    shapes = {"A": (4, 6, 8), "head": (12, 4)}
    cores, spikes = {}, {}
    for k, s in shapes.items():
        d = int(np.prod(s))
        cores[k] = (rng.normal(size=(d, 2)), rng.normal(size=(2, nc)))
        supp = rng.random((d, nc)) < 0.05
        spikes[k] = np.where(supp, 5.0 * rng.normal(size=(d, nc)), 0.0)
    out = []
    for _ in range(rounds):
        tree = {}
        for k, s in shapes.items():
            u, w = cores[k]
            w_t = w + drift * rng.normal(size=w.shape)
            sp_t = spikes[k] * (1.0 + 0.05 * rng.normal(size=spikes[k].shape))
            tree[k] = (u @ w_t + sp_t).T.reshape(nc, *s).astype(np.float32)
        out.append(tree)
    return out


def session_kw(**kw):
    return {**dict(method="fedrpca", rpca_iters=40, svt_mode="subspace",
                   carry_mode="subspace"), **kw}


def tree_equal(a, b):
    return all(torch.equal(x, y) for x, y in zip(tree_leaves(a), tree_leaves(b)))


def basis_np(seed, b, d1, r):
    raw = np.random.default_rng(seed).normal(size=(b, d1, r)).astype(np.float32)
    return np.array(jrpca._orthonormalize(jnp.asarray(raw)))


# ---------------------------------------------------------------------------
# parse_uplink and the byte model
# ---------------------------------------------------------------------------


def test_parse_uplink_defaults_and_explicit():
    assert sketch_lib.parse_uplink(None).mode == "dense"
    assert not sketch_lib.parse_uplink("dense").active
    c = sketch_lib.parse_uplink("sketch")
    assert c.active and c.k == sketch_lib.DEFAULT_K == jsketch.DEFAULT_K
    assert c.energy_tol == sketch_lib.DEFAULT_ENERGY_TOL == jsketch.DEFAULT_ENERGY_TOL
    c = sketch_lib.parse_uplink("sketch:16:0.5")
    assert (c.mode, c.k, c.energy_tol) == ("sketch", 16, 0.5)
    assert sketch_lib.parse_uplink("sketch:16").k == 16
    same = sketch_lib.UplinkConfig(mode="sketch", k=8, energy_tol=0.1)
    assert sketch_lib.parse_uplink(same) is same


@pytest.mark.parametrize("bad", ["dense:4", "sketch:0", "sketch:-1", "sketch:4:2.0",
                                 "sketch:4:-0.1", "sketch:4:0.1:9", "foo", ""])
def test_parse_uplink_rejects(bad):
    with pytest.raises(ValueError):
        sketch_lib.parse_uplink(bad)
    with pytest.raises(ValueError):
        jsketch.parse_uplink(bad)


def test_byte_model_matches_the_reference():
    for dims in ([1024] * 2, [96, 48, 7]):
        assert sketch_lib.dense_bytes_per_client(dims) == jsketch.dense_bytes_per_client(dims)
    for args in ((2, 8, 64), (48, 4, 1)):
        assert sketch_lib.sketch_bytes_per_client(*args) == jsketch.sketch_bytes_per_client(*args)
    assert sketch_lib.basis_bytes(4, 512, 4) == jsketch.basis_bytes(4, 512, 4) == 4 * 4 * 512 * 4
    assert (sketch_lib.dense_bytes_per_client([1024] * 2)
            / sketch_lib.sketch_bytes_per_client(2, 8, 64)) >= 4.0


# ---------------------------------------------------------------------------
# Codec against the reference
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("k", [3, 8, 24])
def test_encode_decode_match_the_reference(k):
    m = np.random.default_rng(k).normal(size=(3, 24, 6)).astype(np.float32)
    basis = basis_np(k + 1, 3, 24, 4)
    js = jsketch.encode_delta(jnp.asarray(m), jnp.asarray(basis), k)
    ts = sketch_lib.encode_delta(torch.from_numpy(m), torch.from_numpy(basis), k)
    np.testing.assert_array_equal(ts.idx.numpy(), np.asarray(js.idx))
    for name in ("coef", "vals", "energy_frac"):
        np.testing.assert_allclose(getattr(ts, name).numpy(), np.asarray(getattr(js, name)),
                                   atol=CODEC_ATOL, err_msg=name)
    jdec = np.asarray(jsketch.decode_into_bucket(js, jnp.asarray(basis)))
    tdec = sketch_lib.decode_into_bucket(ts, torch.from_numpy(basis)).numpy()
    np.testing.assert_allclose(tdec, jdec, atol=CODEC_ATOL)
    if k == m.shape[1]:
        # Full coverage: both decodes are the input bit for bit.
        np.testing.assert_array_equal(tdec, m)
        np.testing.assert_array_equal(jdec, m)


def test_topk_ties_go_to_the_lower_index():
    """Equal residual magnitudes keep the lower position first, as
    ``jax.lax.top_k`` does."""
    m = torch.zeros((1, 6, 1))
    m[0, [1, 4, 5], 0] = torch.tensor([2.0, -2.0, 2.0])
    s = sketch_lib.encode_delta(m, torch.zeros((1, 6, 1)), 2)
    assert s.idx[0, 0].tolist() == [1, 4]
    js = jsketch.encode_delta(jnp.asarray(m.numpy()), jnp.zeros((1, 6, 1)), 2)
    assert np.asarray(js.idx)[0, 0].tolist() == [1, 4]


def test_decode_sets_rather_than_adds():
    """The shipped raw entries overwrite the projection: the decode at a
    shipped position is the raw entry, not projection + entry."""
    m = torch.randn((2, 10, 3), generator=torch.Generator().manual_seed(0))
    basis = torch.from_numpy(basis_np(5, 2, 10, 2))
    s = sketch_lib.encode_delta(m, basis, 4)
    dec = sketch_lib.decode_into_bucket(s, basis).transpose(1, 2)
    assert torch.equal(torch.gather(dec, -1, s.idx), s.vals)


def test_partial_k_energy_monotone_and_small_at_full_k():
    m = torch.from_numpy(np.random.default_rng(0).normal(size=(2, 32, 5)).astype(np.float32))
    basis = torch.from_numpy(basis_np(1, 2, 32, 3))
    fracs = [float(sketch_lib.encode_delta(m, basis, k).energy_frac.max()) for k in (2, 8, 16, 32)]
    assert fracs == sorted(fracs, reverse=True)
    # (resid_sq - kept_sq) / m_sq is kept as written: at full k it cancels
    # to an fp32 floor, not to exactly zero.
    assert fracs[-1] < 1e-5


def test_pure_low_rank_delta_reconstructs():
    b, d1, c, r = 2, 40, 6, 3
    basis = torch.from_numpy(basis_np(2, b, d1, r))
    coef = torch.from_numpy(np.random.default_rng(3).normal(size=(b, r, c)).astype(np.float32))
    m = basis @ coef
    s = sketch_lib.encode_delta(m, basis, 4)
    torch.testing.assert_close(sketch_lib.decode_into_bucket(s, basis), m, atol=1e-5, rtol=1e-5)
    assert float(s.energy_frac.max()) < 1e-6


def test_energy_frac_is_the_decode_error():
    m = torch.from_numpy(np.random.default_rng(4).normal(size=(3, 30, 5)).astype(np.float32))
    basis = torch.from_numpy(basis_np(6, 3, 30, 4))
    s = sketch_lib.encode_delta(m, basis, 6)
    err = (sketch_lib.decode_into_bucket(s, basis) - m).double()
    want = (err ** 2).sum(dim=(1, 2)) / (m.double() ** 2).sum(dim=(1, 2))
    np.testing.assert_allclose(s.energy_frac.double().numpy(), want.numpy(), atol=1e-5, rtol=1e-3)


def test_uplink_basis_matches_the_reference_and_is_zero_when_cold():
    rng = np.random.default_rng(7)
    l = rng.normal(size=(2, 20, 6)).astype(np.float32)
    v = np.linalg.qr(rng.normal(size=(2, 6, 3)))[0].astype(np.float32)
    want = np.asarray(jsketch.uplink_basis(jnp.asarray(l), jnp.asarray(v)))
    got = sketch_lib.uplink_basis(torch.from_numpy(l), torch.from_numpy(v)).numpy()
    np.testing.assert_allclose(got, want, atol=1e-4)
    cold = sketch_lib.uplink_basis(torch.zeros((2, 20, 6)), torch.from_numpy(v))
    assert torch.equal(cold, torch.zeros_like(cold))


# ---------------------------------------------------------------------------
# Engine gate, port against port
# ---------------------------------------------------------------------------


def run_port(trees, uplink=None, **kw):
    cfg = AggregatorConfig(**session_kw(**kw))
    plan = engine_lib.plan_aggregation(from_jax_tree(trees[0]), cfg, uplink=uplink)
    carry = engine_lib.init_agg_carry(plan)
    outs, scalars = [], []
    for t in trees:
        out, carry, diag = engine_lib.aggregate_planned(plan, from_jax_tree(t), carry,
                                                        with_diagnostics=True)
        outs.append(out)
        scalars.append({k: float(v) for k, v in rpca_diag_summary(diag).items()})
    return outs, scalars


def run_jax(trees, uplink=None, **kw):
    cfg = JConfig(**session_kw(**kw))
    jt = [jax.tree_util.tree_map(jnp.asarray, t) for t in trees]
    plan = jengine.plan_aggregation(jt[0], cfg, uplink=uplink)
    carry = jengine.init_agg_carry(plan)
    outs, scalars = [], []
    for t in jt:
        out, carry, diag = jengine.aggregate_planned(plan, t, carry, with_diagnostics=True)
        outs.append(out)
        scalars.append({k: float(v) for k, v in jsummary(diag).items()})
    return outs, scalars


def test_dense_uplink_is_the_no_codec_plan():
    t = from_jax_tree(round_trees(0, rounds=1)[0])
    cfg = AggregatorConfig(**session_kw())
    assert engine_lib.plan_aggregation(t, cfg, uplink="dense").uplink is None
    assert engine_lib.plan_aggregation(t, cfg, uplink=None).uplink is None
    assert engine_lib.plan_aggregation(t, cfg, uplink="sketch:8").uplink.k == 8
    with pytest.warns(UserWarning, match="running dense"):
        plan = engine_lib.plan_aggregation(t, AggregatorConfig(method="fedrpca"), uplink="sketch")
    assert plan.uplink is None


def test_cold_round_is_bitwise_dense():
    trees = round_trees(0, rounds=1)
    dense, _ = run_port(trees)
    sk, sc = run_port(trees, uplink="sketch:8:0.9")
    assert tree_equal(dense[0], sk[0])
    assert sc[0]["uplink_hit_rate"] == 0.0 and sc[0]["uplink_dense_falls"] >= 1.0


def test_zero_tol_gates_every_round_bitwise():
    trees = round_trees(0, rounds=3)
    dense, _ = run_port(trees)
    sk, sc = run_port(trees, uplink="sketch:8:0.0")
    assert all(tree_equal(d, s) for d, s in zip(dense, sk))
    assert all(s["uplink_hit_rate"] == 0.0 for s in sc)


def test_warm_rounds_engage_and_cut_bytes():
    trees = round_trees(0, rounds=4)
    _, sc = run_port(trees, uplink="sketch:16:0.9")
    assert sc[0]["uplink_hit_rate"] == 0.0
    assert all(s["uplink_hit_rate"] == 1.0 for s in sc[1:])
    assert all(s["bytes_up"] < sc[0]["bytes_up"] for s in sc[1:])


def test_gate_trips_on_planted_basis_drift():
    trees = [from_jax_tree(t) for t in round_trees(0, rounds=3)]
    drifted = from_jax_tree(round_trees(99, rounds=1)[0])
    cfg = AggregatorConfig(**session_kw())
    plan = engine_lib.plan_aggregation(trees[0], cfg, uplink="sketch:8:0.3")
    carry = engine_lib.init_agg_carry(plan)
    for t in trees[:2]:
        _, carry, _ = engine_lib.aggregate_planned(plan, t, carry, with_diagnostics=True)
    _, _, diag_a = engine_lib.aggregate_planned(plan, trees[2], carry, with_diagnostics=True)
    assert float(rpca_diag_summary(diag_a)["uplink_hit_rate"]) == 1.0
    out_d, _, diag_d = engine_lib.aggregate_planned(plan, drifted, carry, with_diagnostics=True)
    assert float(rpca_diag_summary(diag_d)["uplink_hit_rate"]) == 0.0
    dense_plan = engine_lib.plan_aggregation(trees[0], cfg)
    out_ref, _, _ = engine_lib.aggregate_planned(dense_plan, drifted, carry,
                                                 with_diagnostics=True)
    assert tree_equal(out_ref, out_d)


@pytest.mark.parametrize("uplink", ["sketch:16:0.9", "sketch:8:0.3"])
def test_sketch_session_matches_the_reference(uplink):
    """Round by round: the same gate decisions and bytes, and updates within
    1e-4 x max|delta| of the reference's."""
    trees = round_trees(0, rounds=4)
    touts, tsc = run_port(trees, uplink=uplink)
    jouts, jsc = run_jax(trees, uplink=uplink)
    for r, (to, jo, ts, js) in enumerate(zip(touts, jouts, tsc, jsc)):
        for key in ("uplink_hit_rate", "uplink_dense_falls", "fallback_count"):
            assert ts[key] == js[key], (r, key, ts[key], js[key])
        np.testing.assert_allclose(ts["bytes_up"], js["bytes_up"], rtol=1e-6)
        np.testing.assert_allclose(ts["bytes_down_basis"], js["bytes_down_basis"], rtol=1e-6)
        scale = max(float(np.abs(x).max()) for x in trees[r].values())
        for g, w in zip(tree_leaves(to), jax.tree_util.tree_leaves(jo)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=SESSION_RTOL * scale,
                                       rtol=0)


def test_agg_session_takes_the_uplink():
    trees = round_trees(1, rounds=3)
    sess = AggSession(AggregatorConfig(**session_kw()), uplink="sketch:16:0.9", device="cpu")
    hits = [float(sess.step(from_jax_tree(t))[1].scalars["uplink_hit_rate"]) for t in trees]
    assert hits == [0.0, 1.0, 1.0]


# ---------------------------------------------------------------------------
# Client ranks
# ---------------------------------------------------------------------------

TASK = dict(n_clients=8, n_per_client=24, d_in=32, d_feat=32, alpha=0.4, seed=3)
LOCAL = dict(local_steps=2, batch_size=8, lr=1e-2)


def test_parse_client_ranks_cycles_and_validates():
    assert partition_lib.parse_client_ranks("8,4", 5, 8).tolist() == [8, 4, 8, 4, 8]
    assert partition_lib.parse_client_ranks([2, 3], 3, 4).tolist() == [2, 3, 2]
    for bad in ("16", "0,4", "", "a,b"):
        with pytest.raises(ValueError):
            partition_lib.parse_client_ranks(bad, 4, 8)
    np.testing.assert_array_equal(partition_lib.parse_client_ranks("4,2,1", 8, 4),
                                  jpartition.parse_client_ranks("4,2,1", 8, 4))


def test_infer_lora_rank():
    task = synth.make_synth_task(**TASK)
    assert partition_lib.infer_lora_rank(synth.init_lora(task)) == task.lora_rank
    with pytest.raises(ValueError):
        partition_lib.infer_lora_rank({"W": torch.zeros((3, 3))})


def test_masks_match_the_reference_and_the_zero_padding_oracle():
    jtask = jsynth.make_synth_task(**TASK)
    jlora = jsynth.init_lora(jtask)
    lora = from_jax_tree(jlora)
    ranks = partition_lib.parse_client_ranks("4,2,1", 8, 4)
    masks = partition_lib.client_rank_masks(lora, ranks)
    jmasks = jpartition.client_rank_masks(jlora, ranks)
    for g, w in zip(tree_leaves(masks), jax.tree_util.tree_leaves(jmasks)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    rng = np.random.default_rng(0)
    deltas = tree_map(lambda x: torch.from_numpy(
        rng.normal(size=(8, *x.shape)).astype(np.float32)), lora)
    masked = tree_map(lambda d, mk: d * mk, deltas, masks)
    a, b = deltas["A"].clone(), deltas["B"].clone()
    for i, r in enumerate(ranks.tolist()):
        a[i, :, r:] = 0.0
        b[i, r:, :] = 0.0
    assert torch.equal(masked["A"], a) and torch.equal(masked["B"], b)


def test_masked_aggregation_is_rank_declaration_invariant():
    task = synth.make_synth_task(**TASK)
    lora = synth.init_lora(task)
    ranks = partition_lib.parse_client_ranks("4,2", 8, 4)
    masks = partition_lib.client_rank_masks(lora, ranks)
    rng = np.random.default_rng(1)
    masked = tree_map(lambda x, mk: torch.from_numpy(
        rng.normal(size=(8, *x.shape)).astype(np.float32)) * mk, lora, masks)
    cfg = AggregatorConfig(**session_kw(rpca_iters=10))
    plain = engine_lib.plan_aggregation(masked, cfg)
    decl = engine_lib.plan_aggregation(masked, cfg, client_ranks=ranks.tolist())
    assert decl.spec.client_ranks == tuple(ranks.tolist()) and plain.spec.client_ranks is None
    out_p, _, _ = engine_lib.aggregate_planned(plain, masked, engine_lib.init_agg_carry(plain),
                                               with_diagnostics=True)
    out_d, _, _ = engine_lib.aggregate_planned(decl, masked, engine_lib.init_agg_carry(decl),
                                               with_diagnostics=True)
    assert tree_equal(out_p, out_d)


# ---------------------------------------------------------------------------
# run_simulation with uplinks and client ranks
# ---------------------------------------------------------------------------


def port_cfg(task, method="fedrpca", rounds=3, **kw):
    agg = dict(method=method, rpca_iters=8)
    if method == "fedrpca":
        agg.update(svt_mode="subspace", carry_mode="subspace")
    local = LocalSpec(loss_fn=lambda b, l, x: synth.loss_fn(b, l, x, 2.0),
                      optimizer=make_optimizer("adam", LOCAL["lr"]), **LOCAL)
    return FedRunConfig(aggregator=AggregatorConfig(**agg), local=local, rounds=rounds, **kw)


def run_port_sim(task, cfg, lora0=None, **kw):
    logs = []
    evalf = lambda l: synth.accuracy(task.base, l, task.test_x, task.test_y, task.lora_scale)
    lora0 = synth.init_lora(task) if lora0 is None else lora0
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        lora, hist = run_simulation(task.base, lora0, task.client_x,
                                    task.client_y, cfg, evalf,
                                    log_fn=lambda r, d: logs.append(d), device="cpu", **kw)
    return lora, hist, logs


def jax_batch_indices(seed, rounds, n_clients, local_steps, batch, n_local):
    rng = jax.random.PRNGKey(seed)
    out = []
    for _ in range(rounds):
        rng, sub, _pick, _agg = jax.random.split(rng, 4)
        out.append(np.asarray([[np.asarray(jax.random.randint(k, (batch,), 0, n_local))
                                for k in jax.random.split(ck, local_steps)]
                               for ck in jax.random.split(sub, n_clients)]))
    return np.stack(out)


@pytest.mark.parametrize("client_ranks", [None, "4,2,1"])
def test_sketch_run_simulation_matches_the_reference(client_ranks):
    rounds = 3
    jtask = jsynth.make_synth_task(**TASK)
    ttask = synth.make_synth_task(**TASK)
    agg = dict(method="fedrpca", rpca_iters=8, svt_mode="subspace", carry_mode="subspace")
    jcfg = JRun(aggregator=JConfig(**agg), rounds=rounds, uplink="sketch:8:0.9",
                client_ranks=client_ranks,
                local=JLocal(loss_fn=lambda b, l, x: jsynth.loss_fn(b, l, x, 2.0),
                             optimizer=jopt("adam", LOCAL["lr"]), **LOCAL))
    jlogs = []
    jeval = lambda l: jsynth.accuracy(jtask.base, l, jtask.test_x, jtask.test_y,
                                      jtask.lora_scale)
    jlora0 = jsynth.init_lora(jtask)
    jlora, jhist = jrun(jtask.base, jlora0, jtask.client_x, jtask.client_y,
                        jcfg, jeval, log_fn=lambda r, d: jlogs.append(d))
    idx = jax_batch_indices(0, rounds, TASK["n_clients"], LOCAL["local_steps"],
                            LOCAL["batch_size"], TASK["n_per_client"])
    tcfg = port_cfg(ttask, rounds=rounds, uplink="sketch:8:0.9", client_ranks=client_ranks)
    tlora, thist, tlogs = run_port_sim(ttask, tcfg, lora0=from_jax_tree(jlora0),
                                       batch_indices=lambda r: idx[r])
    assert [d["uplink_hit_rate"] for d in tlogs] == [float(d["uplink_hit_rate"]) for d in jlogs]
    assert any(d["uplink_hit_rate"] > 0.0 for d in tlogs)
    for t, j in zip(tlogs, jlogs):
        np.testing.assert_allclose(t["bytes_up"], float(j["bytes_up"]), rtol=1e-6)
        np.testing.assert_allclose(t["bytes_down"], float(j["bytes_down"]), rtol=1e-6)
    for g, w in zip(tree_leaves(tlora), jax.tree_util.tree_leaves(jlora)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-3, atol=1e-5)
    np.testing.assert_allclose(thist, jhist, atol=2.0 / 256 + 1e-9)


def test_sketch_cuts_bytes_up_and_adds_the_basis_down():
    task = synth.make_synth_task(**TASK)
    _, _, dense = run_port_sim(task, port_cfg(task))
    _, _, sk = run_port_sim(task, port_cfg(task, uplink="sketch:8:0.9"))
    assert all(d["bytes_up"] > 0 and d["bytes_down"] > 0 for d in dense)
    warm = [d for d in sk if d["uplink_hit_rate"] == 1.0]
    assert warm
    assert all(d["bytes_up"] < dense[-1]["bytes_up"] for d in warm)
    assert all(d["bytes_down"] > dense[-1]["bytes_down"] for d in warm)


@pytest.mark.parametrize("method", ["fedavg", "ties"])
def test_sketch_without_a_carry_runs_dense_bitwise(method):
    task = synth.make_synth_task(**TASK)
    lora_d, hist_d, _ = run_port_sim(task, port_cfg(task, method=method))
    with pytest.warns(UserWarning, match="running dense"):
        cfg = port_cfg(task, method=method, uplink="sketch:8:0.9")
        evalf = lambda l: 0.0
        lora_s, _ = run_simulation(task.base, synth.init_lora(task), task.client_x,
                                   task.client_y, cfg, evalf, device="cpu")
    assert tree_equal(lora_d, lora_s)


def test_full_rank_declaration_is_a_bitwise_noop():
    task = synth.make_synth_task(**TASK)
    lora_p, hist_p, _ = run_port_sim(task, port_cfg(task))
    lora_f, hist_f, _ = run_port_sim(task, port_cfg(task, client_ranks="4"))
    assert tree_equal(lora_p, lora_f)
    np.testing.assert_array_equal(hist_p, hist_f)


def test_hetero_ranks_with_sketch_and_pipeline_run_end_to_end():
    task = synth.make_synth_task(**TASK)
    cfg = port_cfg(task, client_ranks="4,2,1", uplink="sketch:8:0.9", pipeline=True,
                   staleness=2)
    lora, hist, logs = run_port_sim(task, cfg)
    assert np.isfinite(hist).all()
    assert all(torch.isfinite(x).all() for x in tree_leaves(lora))
    assert all("bytes_up" in d for d in logs)
