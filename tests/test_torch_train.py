"""Port LM training against the JAX package, on the CPU at the reduced size
(float32): ``loss_fn`` and its LoRA gradients, the kernels' autograd
Functions, the local and aggregation steps, the synthetic LM data, the
checkpoint container and the train CLI.

Models carry the reference's weights across (``convert.model_from_jax``),
LoRA trees via ``from_jax_tree``.  Tolerances:

* loss: rtol 1e-5 (fp32 sums over B x S tokens and the vocabulary, in
  another order); LoRA gradients: 1e-4 x max|grad| of the leaf (fp32 sums
  of up to B x S x d products through 2 layers; measured ~5e-6).
* ``make_local_step`` deltas: per leaf, ||port - ref|| <= 1e-4 ||ref|| (the
  per-client state bound of ``chip_smoke.py``'s ``STATE_FRO_RTOL``): Adam
  moves elements whose gradient sits near eps with the gradient's last
  bits (measured 4e-5 with Adam, 6e-6 with SGD); with SGD also
  elementwise within 1e-4 x max|delta|.  Reduced RecurrentGemma's Adam
  phase is ill-conditioned in the reference itself: its own deltas move
  3.9e-3 of the norm when the base weights move by 1e-7 relative (the
  port's differ by 1.9e-3, with gradients within 2e-6 of the largest), so
  there the bound is that witness, measured in the test, and never more
  than ADAM_WITNESS_CAP = 5e-3; SGD keeps 1e-4.  The spread sits in one
  leaf, the A factor of the attention layer's value projection
  (``groups[2].mixer.v.A``: 1.9e-3; every other leaf 3e-4 or less), whose
  Adam moves are near eps; with two of four clients active the witness
  reads 3.1e-6.  Its microbatched SGD deltas are at most 7.7e-5, so 1e-4 of them is
  below one fp32 ulp of the LoRA entries (up to 0.4) whose difference a
  delta is: there each element also gets one ulp of its leaf's largest
  entry.
* Functions on the CPU run the plain forward; their hand-written backward
  passes equal the plain version's autograd: LoRA and attention to 1e-6
  (the same fp32 operations), bf16 LoRA dx within two bf16 ulps of its
  largest entry (g W^T is rounded to bf16 first, as the reference's
  autodiff of a bf16 product is); the SSD's chunked recompute against the
  sequential scan's autograd within 1e-4 of the largest gradient entry.
* Aggregation updates: 1e-4 x max|delta| (``tests/test_torch_session.py``).
* Synthetic data: bitwise (pure numpy on both sides).
"""
import os
import subprocess
import sys
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import AggregatorConfig as JConfig
from repro.data import synthetic as jsynthetic
from repro.launch import steps as jsteps
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.optim import schedules as jschedules
from repro_torch import models
from repro_torch.checkpoint import (
    CheckpointCorruptError,
    checkpoint_metadata,
    load_pytree,
    restore_checkpoint,
    save_checkpoint,
    save_pytree,
)
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.core import AggregatorConfig, engine
from repro_torch.data import synthetic
from repro_torch.kernels import ops, ref
from repro_torch.kernels import lora_matmul as lm
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.optim import schedules
from repro_torch.utils.pytree import tree_leaves, tree_map

ARCHS = ["stablelm-1.6b", "mamba2-130m", "recurrentgemma-2b"]
# Architectures whose Adam local phase is held to the reference's own spread
# under a WITNESS_PERTURB relative perturbation of the base weights.
ADAM_WITNESS_ARCHS = ("recurrentgemma-2b",)
WITNESS_PERTURB = 1e-7
ADAM_WITNESS_CAP = 5e-3
# Architectures whose microbatched deltas sit below the LoRA entries' ulp.
ULP_FLOOR_ARCHS = ("recurrentgemma-2b",)
GRAD_RTOL = 1e-4
STATE_FRO_RTOL = 1e-4
AGG_RTOL = 1e-4
ROOT = os.path.join(os.path.dirname(__file__), "..")


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """A reduced model in both packages on the same weights, and a LoRA
    tree with nonzero B (so every leaf has a gradient)."""
    arch = request.param
    jcfg, cfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32),
        jinit_lora(jax.random.PRNGKey(1), jcfg))
    return dict(arch=arch, jcfg=jcfg, cfg=cfg, jp=jp, model=model, jl=jl,
                tl=from_jax_tree(jax.tree_util.tree_map(np.asarray, jl)))


def lm_batch(cfg, shape, seed=2):
    toks = np.random.default_rng(seed).integers(0, cfg.vocab_size, size=(*shape[:-1],
                                                                          shape[-1] + 1))
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}


def leaf_errs(got, want):
    """Per leaf: (max abs error, max |ref|, ||err|| / ||ref||)."""
    out = []
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        w = torch.from_numpy(np.array(w))
        g = g.detach().float()
        out.append((float((g - w).abs().max()), float(w.abs().max()),
                    float((g - w).norm() / torch.clamp_min(w.norm(), 1e-30))))
    return out


# ---------------------------------------------------------------------------
# loss_fn and its LoRA gradients
# ---------------------------------------------------------------------------


def test_loss_and_lora_grads_match_jax(pair):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    batch = lm_batch(cfg, (3, 32))
    batch["labels"][0, :5] = -1  # masked labels
    (jtot, jaux), jg = jax.value_and_grad(
        lambda l: jloss(pair["jp"], l, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                        remat=False), has_aux=True)(pair["jl"])
    live = tree_map(lambda t: t.clone().requires_grad_(), pair["tl"])
    tot, aux = models.loss_fn(pair["model"], live,
                              {k: torch.as_tensor(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(tot, tree_leaves(live))
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    np.testing.assert_allclose(float(aux["ce"]), float(jaux["ce"]), rtol=1e-5)
    assert float(aux["aux"]) == float(jaux["aux"]) == 0.0
    for err, scale, _ in leaf_errs(grads, jax.tree_util.tree_leaves(jg)):
        assert scale > 0 and err <= GRAD_RTOL * scale, (err, scale)


def test_remat_gives_the_same_gradients(pair):
    cfg = pair["cfg"]
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(cfg, (2, 16)).items()}
    out = []
    for remat in (False, True):
        live = tree_map(lambda t: t.clone().requires_grad_(), pair["tl"])
        tot, _ = models.loss_fn(pair["model"], live, batch, cfg, remat=remat)
        out.append(torch.autograd.grad(tot, tree_leaves(live)))
    for a, b in zip(*out):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_client_losses_are_per_client_loss_fn(pair):
    cfg, model = pair["cfg"], pair["model"]
    batch = {k: torch.as_tensor(v) for k, v in lm_batch(cfg, (4, 16)).items()}
    with torch.no_grad():
        per = models.client_losses(model, pair["tl"], batch, cfg, 2)
        for c in range(2):
            rows = {k: v[2 * c:2 * c + 2] for k, v in batch.items()}
            want = models.loss_fn(model, pair["tl"], rows, cfg)[0]
            torch.testing.assert_close(per[c], want, atol=1e-6, rtol=1e-6)


# ---------------------------------------------------------------------------
# The kernels' autograd Functions against the plain version's autograd
# ---------------------------------------------------------------------------


def _grads(fn, ins, g):
    live = [t.clone().requires_grad_() for t in ins]
    out = fn(*live)
    return torch.autograd.grad(out, live, g)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("gathered", [False, True])
def test_lora_function_grads_match_plain_autograd(dtype, gathered):
    gen = torch.Generator().manual_seed(3)
    m, k, n, r, slots = 24, 40, 24, 4, 3
    x = torch.randn((m, k), generator=gen).to(dtype)
    w = torch.randn((k, n), generator=gen).to(dtype)
    a = torch.randn((slots, k, r), generator=gen)
    b = torch.randn((slots, r, n), generator=gen)
    row_slot = torch.tensor([0, 1, 2, -1] * 6, dtype=torch.int32)
    g = torch.randn((m, n), generator=gen).to(dtype)
    if gathered:
        fn = lambda x_, a_, b_: lm.gathered_lora_matmul(x_, w, a_, b_, row_slot, 2.0)
        plain = lambda x_, a_, b_: ref.gathered_lora_matmul_ref(x_, w, a_, b_, row_slot, 2.0)
        ins = (x, a, b)
    else:
        fn = lambda x_, a_, b_: lm.lora_matmul(x_, w, a_, b_, 2.0)
        plain = lambda x_, a_, b_: ref.lora_matmul_ref(x_, w, a_, b_, 2.0)
        ins = (x, a[0], b[0])
    got, want = _grads(fn, ins, g), _grads(plain, ins, g)
    assert got[0].dtype == dtype and got[1].dtype == got[2].dtype == torch.float32
    # W is frozen: the Function gives it no gradient.
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 0.0
    torch.testing.assert_close(got[0].float(), want[0].float(), rtol=0,
                               atol=2 * ulp * float(want[0].float().abs().max()) + 1e-6)
    for gg, ww in zip(got[1:], want[1:]):
        torch.testing.assert_close(gg, ww, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("group", [1, 2])
def test_attention_function_grads_match_plain_autograd(group):
    gen = torch.Generator().manual_seed(4)
    q = torch.randn((2, 20, 4, 8), generator=gen)
    k = torch.randn((2, 20, 4 // group, 8), generator=gen)
    v = torch.randn((2, 20, 4 // group, 8), generator=gen)
    g = torch.randn((2, 20, 4, 8), generator=gen)

    def plain(q_, k_, v_):
        bsz, s, h, d = q_.shape
        kk = k_.repeat_interleave(group, dim=2)
        vv = v_.repeat_interleave(group, dim=2)
        fold = lambda t: t.transpose(1, 2).reshape(bsz * h, s, d)
        out = ref.local_attention_ref(fold(q_), fold(kk), fold(vv), window=0)
        return out.reshape(bsz, h, s, d).transpose(1, 2)

    got = _grads(lambda *t: ops.local_attention(*t), (q, k, v), g)
    want = _grads(plain, (q, k, v), g)
    assert got[1].shape == k.shape  # summed back over each group of query heads
    for gg, ww in zip(got, want):
        torch.testing.assert_close(gg, ww, atol=1e-6, rtol=1e-6)


@pytest.mark.parametrize("bh,groups,s,chunk", [(6, 2, 37, 16), (4, 4, 64, 16), (3, 1, 20, 256)])
def test_ssd_function_grads_match_plain_autograd(bh, groups, s, chunk):
    gen = torch.Generator().manual_seed(5)
    x = torch.randn((bh, s, 8), generator=gen)
    da = -torch.rand((bh, s), generator=gen)
    b = torch.randn((groups, s, 6), generator=gen)
    c = torch.randn((groups, s, 6), generator=gen)
    gy = torch.randn((bh, s, 8), generator=gen)
    gh = torch.randn((bh, 6, 8), generator=gen)
    for with_state in (False, True):
        def run(fn):
            live = [t.clone().requires_grad_() for t in (x, da, b, c)]
            out = fn(*live, chunk=chunk, return_state=with_state)
            outs, gs = ((out[0], out[1]), (gy, gh)) if with_state else ((out,), (gy,))
            return torch.autograd.grad(outs, live, gs)

        got = run(lambda *t, **kw: ops.ssd_scan(*t, **kw))
        want = run(lambda *t, chunk, return_state: ref.ssd_scan_ref(
            *t, chunk, return_state=return_state))
        for gg, ww in zip(got, want):
            torch.testing.assert_close(gg, ww, rtol=0, atol=1e-4 * float(ww.abs().max()))


def test_ssd_chunked_ref_matches_the_sequential_scan():
    gen = torch.Generator().manual_seed(6)
    x = torch.randn((4, 50, 8), generator=gen)
    da = -torch.rand((4, 50), generator=gen)
    b, c = torch.randn((2, 50, 5), generator=gen), torch.randn((2, 50, 5), generator=gen)
    y, h = ref.ssd_chunked_ref(x, da, b, c, 16, return_state=True)
    ys, hs = ref.ssd_scan_ref(x, da, b, c, return_state=True)
    torch.testing.assert_close(y, ys, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, hs, atol=1e-5, rtol=1e-5)


# ---------------------------------------------------------------------------
# The local and aggregation steps against the reference
# ---------------------------------------------------------------------------


def reference_witness(jstep, pair, jbatch, key, want):
    """The largest per-leaf ||d - want|| / ||want|| of the reference's own
    deltas ``d`` from base weights perturbed by ``WITNESS_PERTURB``."""
    rng = np.random.default_rng(9)
    jp = jax.tree_util.tree_map(
        lambda a: (a * (1 + WITNESS_PERTURB * rng.normal(size=a.shape))).astype(a.dtype)
        if a.dtype == jnp.float32 else a, pair["jp"])
    got = jstep(jp, pair["jl"], jbatch, key)[0]
    return max(float(np.linalg.norm(np.array(g) - np.array(w)) / np.linalg.norm(np.array(w)))
               for g, w in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(want)))


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
@pytest.mark.parametrize("clients_per_round", [0, 2])
def test_local_step_matches_jax(pair, optimizer, clients_per_round):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    batch = lm_batch(cfg, (4, 2, 16))
    kw = dict(local_lr=1e-2, local_steps=2, local_optimizer=optimizer, remat=False,
              clients_per_round=clients_per_round)
    jstep = jax.jit(jsteps.make_local_step(jcfg, **kw))
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    jd, jl_, jmask = jstep(pair["jp"], pair["jl"], jbatch, jax.random.PRNGKey(5))
    bound = STATE_FRO_RTOL
    if optimizer == "adam" and pair["arch"] in ADAM_WITNESS_ARCHS:
        bound = min(ADAM_WITNESS_CAP,
                    max(bound, reference_witness(jstep, pair, jbatch, jax.random.PRNGKey(5), jd)))
    mask = None if jmask is None else np.array(jmask)
    td, tl_, tmask = steps.make_local_step(cfg, **kw)(
        pair["model"], pair["tl"], {k: torch.as_tensor(v) for k, v in batch.items()}, (0, 5),
        mask=mask)
    assert (tmask is None) == (mask is None)
    if mask is not None:
        np.testing.assert_array_equal(tmask.numpy(), mask)
        for d in tree_leaves(td):  # masked slots: exact zeros
            assert not d[torch.from_numpy(mask) == 0].any()
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    for err, scale, fro in leaf_errs(td, jd):
        assert fro <= bound, (fro, bound)
        if optimizer == "sgd":
            assert err <= 1e-4 * scale, (err, scale)


def test_microbatched_local_step_matches_jax(pair):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    batch = lm_batch(cfg, (2, 4, 8), seed=7)
    kw = dict(local_lr=1e-2, local_steps=1, local_optimizer="sgd", remat=False, microbatch=2)
    jd, jl_, _ = jax.jit(jsteps.make_local_step(jcfg, **kw))(
        pair["jp"], pair["jl"], {k: jnp.asarray(v) for k, v in batch.items()})
    td, tl_, _ = steps.make_local_step(cfg, **kw)(
        pair["model"], pair["tl"], {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    floors = [float(np.spacing(np.float32(x.abs().max()))) if pair["arch"] in ULP_FLOOR_ARCHS
              else 0.0 for x in tree_leaves(pair["tl"])]
    for (err, scale, fro), floor in zip(leaf_errs(td, jd), floors):
        assert err <= 1e-4 * scale + floor and fro <= STATE_FRO_RTOL


def test_cohort_mask_is_a_pure_function_of_the_key():
    a = steps.cohort_mask((0, 7), 8, 3)
    assert torch.equal(a, steps.cohort_mask((0, 7), 8, 3)) and float(a.sum()) == 3.0
    assert not all(torch.equal(a, steps.cohort_mask((0, r), 8, 3)) for r in range(8, 16))


def delta_trees(pair, seed, n=6):
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda a: (0.01 * rng.normal(size=(n, *a.shape))).astype(np.float32), pair["jl"])


@pytest.mark.parametrize("method,carry", [("fedavg", "none"), ("fedrpca", "none"),
                                          ("fedrpca", "subspace")])
def test_agg_step_matches_jax(pair, method, carry):
    kw = dict(method=method, rpca_iters=10, carry_mode=carry,
              svt_mode="subspace" if carry == "subspace" else "gram")
    jstep = jsteps.make_agg_step(JConfig(**kw))
    tstep = steps.make_agg_step(AggregatorConfig(**kw))
    assert tstep.carry_on == jstep.carry_on == (carry != "none")
    jcarry = tcarry = None
    if carry != "none":
        d0 = jax.tree_util.tree_map(jnp.asarray, delta_trees(pair, 0))
        from repro.core import engine as jengine

        jcarry = jengine.init_agg_carry(jengine.plan_aggregation(d0, JConfig(**kw)))
    for r in range(2):
        d = delta_trees(pair, r)
        mask = np.array([1, 1, 0, 1, 1, 1], np.float32)
        if carry != "none":
            jupd, jm, jcarry = jstep(jax.tree_util.tree_map(jnp.asarray, d), jnp.asarray(mask),
                                     None, jcarry, 0.5)
            tupd, tm, tcarry = tstep(from_jax_tree(d), torch.from_numpy(mask), None, tcarry, 0.5)
            assert float(tm["fallback_count"]) == float(jm["fallback_count"])
        else:
            jupd, _ = jstep(jax.tree_util.tree_map(jnp.asarray, d), jnp.asarray(mask), scale=0.5)
            tupd, _ = tstep(from_jax_tree(d), torch.from_numpy(mask), scale=0.5)
        scale = max(float(np.abs(x).max()) for x in jax.tree_util.tree_leaves(d))
        for err, _, _ in leaf_errs(tupd, jupd):
            assert err <= AGG_RTOL * scale


def test_fed_and_single_train_steps_match_jax(pair):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    batch = lm_batch(cfg, (3, 2, 12), seed=8)
    agg = dict(method="fedavg")
    jnew, jm = jsteps.make_fed_train_step(jcfg, JConfig(**agg), local_lr=1e-2, remat=False)(
        pair["jp"], pair["jl"], {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = steps.make_fed_train_step(cfg, AggregatorConfig(**agg), local_lr=1e-2,
                                         remat=False)(
        pair["model"], pair["tl"], {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for err, scale, _ in leaf_errs(tnew, jnew):
        assert err <= 1e-5 * scale
    flat = {k: v.reshape(-1, v.shape[-1]) for k, v in batch.items()}
    jnew, jl_ = jsteps.make_single_train_step(jcfg, lr=1e-2, remat=False)(
        pair["jp"], pair["jl"], {k: jnp.asarray(v) for k, v in flat.items()})
    tnew, tl_ = steps.make_single_train_step(cfg, lr=1e-2, remat=False)(
        pair["model"], pair["tl"], {k: torch.as_tensor(v) for k, v in flat.items()})
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    for err, scale, _ in leaf_errs(tnew, jnew):
        assert err <= 1e-5 * scale


# ---------------------------------------------------------------------------
# Synthetic data and schedules
# ---------------------------------------------------------------------------


def test_synthetic_data_is_the_reference_bitwise():
    ct, test = synthetic.client_lm_datasets(3, vocab_size=64, n_seqs=8, seq_len=16,
                                            heterogeneity=0.5, seed=4)
    jct, jtest = jsynthetic.client_lm_datasets(3, vocab_size=64, n_seqs=8, seq_len=16,
                                               heterogeneity=0.5, seed=4)
    np.testing.assert_array_equal(ct, jct)
    np.testing.assert_array_equal(test.tokens, jtest.tokens)
    d, jd = synthetic.make_lm_data(64, 8, 16, seed=1), jsynthetic.make_lm_data(64, 8, 16, seed=1)
    np.testing.assert_array_equal(d.tokens, jd.tokens)
    for a, b, _ in zip(synthetic.make_lm_batches(d, 4, seed=2),
                       jsynthetic.make_lm_batches(jd, 4, seed=2), range(3)):
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_schedules_match_the_reference():
    for name, args in [("constant_schedule", (0.1,)), ("cosine_schedule", (0.1, 50)),
                       ("linear_warmup_cosine", (0.1, 10, 50))]:
        fn, jfn = getattr(schedules, name)(*args), getattr(jschedules, name)(*args)
        for step in (0, 3, 10, 25, 60):
            np.testing.assert_allclose(float(fn(step)), float(jfn(jnp.asarray(step))),
                                       rtol=1e-6)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


def test_checkpoint_roundtrip(tmp_path):
    gen = torch.Generator().manual_seed(0)
    tree = {"a": torch.randn((4, 5), generator=gen),
            "b": {"c": torch.randn((3,), generator=gen).to(torch.bfloat16)},
            "d": torch.tensor([1, 2, 3], dtype=torch.int32)}
    save_pytree(tree, str(tmp_path / "x"), {"note": "x"})
    restored, meta = load_pytree(str(tmp_path / "x"), tree)
    assert meta["note"] == "x"
    for a, b in zip(tree_leaves(tree), tree_leaves(restored)):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_checkpoint_retention(tmp_path):
    tree = {"a": torch.zeros((2,))}
    for step in range(6):
        save_checkpoint(tree, str(tmp_path), step, keep=3)
    _, meta = restore_checkpoint(str(tmp_path), tree)
    assert meta["step"] == 5 and len(os.listdir(tmp_path)) == 3
    assert checkpoint_metadata(str(tmp_path), 4)["step"] == 4


def test_checkpoint_shape_mismatch_raises(tmp_path):
    save_pytree({"a": torch.zeros((2,))}, str(tmp_path / "x"))
    with pytest.raises(ValueError, match="shape mismatch"):
        load_pytree(str(tmp_path / "x"), {"a": torch.zeros((3,))})
    with pytest.raises(ValueError, match="leaves"):
        load_pytree(str(tmp_path / "x"), {"a": torch.zeros((2,)), "b": torch.zeros((1,))})


@pytest.mark.parametrize("damage", ["flip", "truncate"])
def test_corrupt_checkpoint_falls_back_to_the_previous_step(tmp_path, damage):
    for step in (1, 2):
        save_checkpoint({"a": torch.full((64,), float(step))}, str(tmp_path), step)
    path = tmp_path / "step_00000002" / "state.pt"
    raw = bytearray(path.read_bytes())
    if damage == "flip":
        # Flip a byte of the last float payload (float 2.0 -> another value).
        pos = raw.rfind(np.float32(2.0).tobytes())
        raw[pos + 3] ^= 0x01
    else:
        raw = raw[: len(raw) // 2]
    path.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(str(tmp_path), {"a": torch.zeros((64,))}, step=2)
    with pytest.warns(UserWarning, match="corrupted checkpoint step 2"):
        tree, meta = restore_checkpoint(str(tmp_path), {"a": torch.zeros((64,))})
    assert meta["step"] == 1 and torch.equal(tree["a"], torch.full((64,), 1.0))


def test_session_checkpoint_carries_the_agg_carry(tmp_path):
    cfg = AggregatorConfig(method="fedrpca", svt_mode="subspace", carry_mode="subspace",
                           rpca_iters=10)
    d = {"w": torch.randn((6, 8, 5), generator=torch.Generator().manual_seed(1))}
    plan = engine.plan_aggregation(d, cfg)
    _, carry = engine.aggregate_planned(plan, d, engine.init_agg_carry(plan))
    save_checkpoint({"lora": {"w": d["w"][0]}, "agg_carry": carry}, str(tmp_path), 3,
                    metadata={"format": "session", "carry_mode": "subspace"})
    like = {"lora": {"w": torch.zeros((8, 5))}, "agg_carry": engine.init_agg_carry(plan)}
    restored, meta = restore_checkpoint(str(tmp_path), like)
    assert meta["format"] == "session" and bool(restored["agg_carry"][next(iter(carry))].valid)
    for a, b in zip(tree_leaves(carry), tree_leaves(restored["agg_carry"])):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The train CLI
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("argv", [["--carry-mode", "subspace", "--engine", "reference"],
                                  ["--carry-mode", "full", "--aggregator", "fedavg"]])
def test_inert_carry_flag_refused(argv):
    with pytest.raises(SystemExit) as exc:
        train_cli.main(argv + ["--rounds", "1", "--clients", "2", "--reduced", "--device", "cpu"])
    assert exc.value.code == 2


def test_negative_staleness_refused():
    with pytest.raises(SystemExit) as exc:
        train_cli.main(["--rounds", "1", "--clients", "2", "--reduced", "--device", "cpu",
                        "--pipeline", "--staleness", "-1"])
    assert exc.value.code == 2


def test_bad_faults_spec_refused():
    with pytest.raises(ValueError, match="faults"):
        train_cli.main(["--rounds", "1", "--clients", "2", "--reduced", "--device", "cpu",
                        "--faults", "bogus"])


def test_cli_needs_an_explicit_cpu(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_cli.main(["--rounds", "1", "--clients", "2", "--reduced"])


@pytest.mark.parametrize("arch", ARCHS)
def test_cli_reduced_two_rounds_exit_zero(arch):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", arch, "--reduced",
         "--device", "cpu", "--rounds", "2", "--clients", "4"],
        capture_output=True, text=True, env=env, timeout=300, cwd=ROOT)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert "final eval loss" in proc.stderr and "round 001" in proc.stderr


def test_cli_sketch_ranks_pipeline_and_faults_run():
    out = train_cli.main(["--arch", "mamba2-130m", "--reduced", "--device", "cpu", "--rounds",
                          "3", "--clients", "6", "--per-client-batch", "2", "--seq", "16",
                          "--svt-mode", "subspace", "--carry-mode", "subspace",
                          "--rpca-iters", "8", "--uplink", "sketch:16:1.0",
                          "--client-ranks", "4,2", "--pipeline", "--staleness", "1",
                          "--faults", "nan:0.2"])
    hits = [r["uplink_hit_rate"] for r in out["rounds"]]
    assert hits[0] == 0.0 and hits[1:] == [1.0, 1.0]  # tol 1.0: every warm round sketches
    assert all(r["screen_clean"] == 1.0 for r in out["rounds"])
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out["lora"]))


def test_cli_resume_continues_the_session(tmp_path):
    base = ["--arch", "stablelm-1.6b", "--reduced", "--device", "cpu", "--clients", "4",
            "--per-client-batch", "2", "--seq", "16", "--svt-mode", "subspace",
            "--carry-mode", "subspace", "--rpca-iters", "8", "--uplink", "sketch:16:1.0"]
    whole = train_cli.main(base + ["--rounds", "3"])
    ck = str(tmp_path / "ck")
    train_cli.main(base + ["--rounds", "2", "--ckpt-dir", ck, "--ckpt-every", "1"])
    assert checkpoint_metadata(ck)["format"] == "session"
    resumed = train_cli.main(base + ["--rounds", "3", "--ckpt-dir", ck, "--resume"])
    assert [r["round"] for r in resumed["rounds"]] == [2]
    assert resumed["rounds"][0]["uplink_hit_rate"] == 1.0  # the carry came back warm
    for a, b in zip(tree_leaves(whole["lora"]), tree_leaves(resumed["lora"])):
        assert torch.equal(a, b)
