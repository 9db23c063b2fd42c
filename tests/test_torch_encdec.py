"""The port's encoder-decoder config (Whisper-medium) against the JAX
package, on the CPU at the reduced size in float32: the config and the full
model's parameter count (built unfilled on the meta device); ``encode`` and
the train-mode logits; prefill and decode through the cross caches (never
padded); the loss and its LoRA gradients (cross adapters included); the
adapter pool and ``serve_batch`` with the audio-frame stub drawn from one
seed in both packages (``_make_batch``); ``gather_adapters``; and the
federated local step with the stub riding along the client axis.  Weights
come across with ``convert.model_from_jax``.

Tolerances: logits and encoder outputs 2e-5 of the largest (2 + 2 layers
of fp32 sums of up to 512 products, softmax and norms in another order;
``tests/test_torch_models.py``); caches 1e-5 of the largest entry; loss
rtol 1e-5 and LoRA gradients 1e-4 of each leaf's largest
(``tests/test_torch_train.py``); local-step deltas per leaf within 1e-4 of
the reference's norm (SGD also elementwise within 1e-4 of the largest);
frontend stubs bitwise (both packages draw them from numpy).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import AggregatorConfig as JConfig
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import model as jmodel
from repro.serve import AdapterPool as JPool
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.core import AggregatorConfig
from repro_torch.kernels import lora_matmul as lm
from repro_torch.launch import serve, steps
from repro_torch.models.kvcache import KVCache
from repro_torch.serve import AdapterPool, adapter_view
from repro_torch.utils.pytree import tree_leaves, tree_map

ARCH = "whisper-medium"
LOGIT_RTOL = 2e-5
CACHE_RTOL = 1e-5
GRAD_RTOL = 1e-4
STATE_FRO_RTOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol, what=""):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=0,
                               atol=rtol * float(np.abs(want).max()), err_msg=what)


@pytest.fixture(scope="module")
def pair():
    """Reduced Whisper in both packages on the same weights, a LoRA tree
    with nonzero B (decoder self and cross adapters), and a batch of 3
    prompts of 20 tokens over stub frames."""
    jcfg, cfg = jconfigs.get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32),
        jinit_lora(jax.random.PRNGKey(1), jcfg))
    toks = rng.integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    frames = rng.normal(size=(3, cfg.encoder_seq, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, model=model, jl=jl,
                tl=from_jax_tree(jax.tree_util.tree_map(np.asarray, jl)),
                jbatch={"tokens": jnp.asarray(toks), "encoder_frames": jnp.asarray(frames)},
                tbatch={"tokens": T(toks).long(), "encoder_frames": T(frames)})


def test_config_matches_reference_and_builds_at_full_width():
    """Field for field, reduced too; the full model built unfilled on the
    meta device has the reference's parameter count (encoder, both position
    tables, cross sub-blocks and biases)."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jconfigs.get_config(ARCH))
    assert (dataclasses.asdict(get_config(ARCH).reduced())
            == dataclasses.asdict(jconfigs.get_config(ARCH).reduced()))
    cfg = get_config(ARCH)
    model = models.DecoderLM(cfg, None, device="meta")
    assert len(model.encoder.layers) == 24 and len(model.layers) == 24
    assert all(hasattr(b, "cross") for b in model.layers)
    assert not any(hasattr(b, "cross") for b in model.encoder.layers)
    assert tuple(model.pos_embed.shape) == (32768, 1024)
    assert tuple(model.encoder.pos_embed.shape) == (1500, 1024)
    want = jax.eval_shape(lambda k: jinit(k, jconfigs.get_config(ARCH)), jax.random.PRNGKey(0))
    assert models.model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


def test_sinusoidal_table_matches_reference():
    """Within two ulps of the largest float32 angle (position 1499 x
    frequency 1): each library's exp rounds the frequencies, and the
    product's rounding moves sin and cos by up to that much."""
    got = models.model._sinusoidal(1500, 1024, "cpu")
    want = np.asarray(jmodel._sinusoidal(1500, 1024))
    np.testing.assert_allclose(got.numpy(), want, atol=2 * float(np.spacing(np.float32(1499))),
                               rtol=0)


def test_encode_and_train_forward_match_jax(pair):
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    want = jmodel.encode(pair["jp"], pair["jbatch"], jcfg)
    got = models.encode(pair["model"], pair["tbatch"], cfg)
    close(got.numpy(), want, LOGIT_RTOL, "encode")
    for jl, tl in ((None, None), (pair["jl"], pair["tl"])):
        jlog, _, _ = jforward(pair["jp"], jl, pair["jbatch"], jcfg, mode="train", remat=False)
        tlog, tc, _ = models.forward(pair["model"], tl, pair["tbatch"], cfg, mode="train")
        assert tc is None and tlog.shape == (3, 20, cfg.vocab_size)
        close(tlog.numpy(), jlog, LOGIT_RTOL, "train logits")


@pytest.mark.parametrize("adapter", ["none", "single"])
def test_prefill_and_decode_match_jax(pair, adapter):
    """Prefill logits and caches (self, and the cross cache of the encoder's
    K and V, projected once), then 3 decode steps reading the cross caches."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jl, tl = (None, None) if adapter == "none" else (pair["jl"], pair["tl"])
    jlog, jc, _ = jforward(pair["jp"], jl, pair["jbatch"], jcfg, mode="prefill", remat=False)
    tlog, tc, _ = models.forward(pair["model"], tl, pair["tbatch"], cfg, mode="prefill")
    tol = LOGIT_RTOL * float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    for key in ("self", "cross"):
        for t, j in zip(tc["groups"][0][key], jc["groups"][0][key]):
            assert tuple(t.shape) == tuple(j.shape)
            close(t.numpy(), j, CACHE_RTOL, key)
    assert tc["groups"][0]["cross"].k.shape[2] == cfg.encoder_seq
    jc, tc = jextend(jc, 3, jcfg), models.extend_caches(tc, 3, cfg)
    tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
    for i in range(3):
        jlog, jc = jdecode(pair["jp"], jl, jnp.asarray(tok), jc, jnp.asarray(20 + i), jcfg)
        tlog, tc = models.decode_step(pair["model"], tl, T(tok).long(), tc, 20 + i, cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
        tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)


def test_cross_caches_are_never_padded(pair):
    """``extend_caches`` pads the self caches by ``extra`` and passes the
    cross caches through untouched; ``init_decode_caches`` gives every
    layer a cross cache of ``encoder_seq`` positions beside the self cache."""
    cfg = pair["cfg"]
    _, caches, _ = models.forward(pair["model"], None, pair["tbatch"], cfg, mode="prefill")
    out = models.extend_caches(caches, 5, cfg)
    g, h = caches["groups"][0], out["groups"][0]
    assert h["self"].k.shape[2] == g["self"].k.shape[2] + 5 == 25
    assert h["cross"] is g["cross"]
    fresh = models.init_decode_caches(cfg, 2, 30, device="cpu")["groups"][0]
    assert isinstance(fresh["cross"], KVCache)
    assert tuple(fresh["cross"].k.shape) == (cfg.n_layers, 2, cfg.encoder_seq, cfg.n_kv_heads,
                                             cfg.head_dim_)
    assert fresh["self"].k.shape[2] == 30


def test_fresh_lora_is_a_noop_and_lora_gradients_match_jax(pair):
    """A fresh adapter (B = 0) leaves the logits as no adapter does; the loss
    and every LoRA leaf's gradient (self and cross, q and v) match the
    reference's autodiff and none is zero."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    fresh = models.init_lora_params(cfg, seed=3, device="cpu")
    assert sorted(fresh["groups"][0]) == ["cross", "mixer"]
    plain = models.forward(pair["model"], None, pair["tbatch"], cfg, mode="train")[0]
    with_fresh = models.forward(pair["model"], fresh, pair["tbatch"], cfg, mode="train")[0]
    torch.testing.assert_close(with_fresh, plain, atol=1e-6 * float(plain.abs().max()), rtol=0)

    labels = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(3, 20))
    labels[0, :5] = -1
    jb = dict(pair["jbatch"], labels=jnp.asarray(labels))
    tb = dict(pair["tbatch"], labels=T(labels))
    (jtot, _), jg = jax.value_and_grad(
        lambda l: jloss(pair["jp"], l, jb, jcfg, remat=False), has_aux=True)(pair["jl"])
    live = tree_map(lambda t: t.clone().requires_grad_(), pair["tl"])
    tot, _ = models.loss_fn(pair["model"], live, tb, cfg, remat=True)
    grads = torch.autograd.grad(tot, tree_leaves(live))
    np.testing.assert_allclose(float(tot.detach()), float(jtot), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        w = np.asarray(w)
        assert np.abs(w).max() > 0 and float(g.abs().max()) > 0
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_RTOL * np.abs(w).max(), rtol=0)


@pytest.mark.parametrize("arch", ["whisper-medium", "qwen2-vl-2b", "stablelm-1.6b"])
def test_make_batch_stubs_equal_the_reference(arch):
    """One seed, the prompts drawn first: the stubs are the reference's bits
    (``encoder_frames`` for Whisper, ``vision_embeds`` for Qwen2-VL, none
    for a text config)."""
    jcfg, cfg = jconfigs.get_config(arch).reduced(), get_config(arch).reduced()
    jrng, trng = np.random.default_rng(7), np.random.default_rng(7)
    jtoks = jrng.integers(0, cfg.vocab_size, size=(2, 9))
    ttoks = trng.integers(0, cfg.vocab_size, size=(2, 9))
    want = jserve._make_batch(jcfg, jnp.asarray(jtoks), jrng)
    got = serve._make_batch(cfg, torch.as_tensor(ttoks), trng)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]))
    if cfg.frontend:
        with pytest.raises(ValueError, match="rng"):
            serve._make_batch(cfg, torch.as_tensor(ttoks), None)


def test_gather_adapters_matches_reference(pair):
    rng = np.random.default_rng(8)
    stacked = jax.tree_util.tree_map(
        lambda a: rng.normal(size=(3, *a.shape)).astype(np.float32), pair["jl"])
    ids = np.array([2, 0, 2, 1])
    want = jserve.gather_adapters(jax.tree_util.tree_map(jnp.asarray, stacked),
                                  jnp.asarray(ids))
    got = serve.gather_adapters(from_jax_tree(stacked), torch.as_tensor(ids))
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_pool_carries_the_cross_subtree(pair):
    """``AdapterPool`` holds, views and hot-swaps the ``cross`` adapters: the
    view's cross leaves are the pool's in place, and ``publish_round``
    writes the cross leaves of the new tree."""
    cfg = pair["cfg"]
    pool = AdapterPool(models.init_lora_params(cfg, seed=0, device="cpu"), 3)
    pool.publish("t", pair["tl"])
    view = adapter_view(pool.pooled, torch.tensor([0, 0], dtype=torch.int32))
    a = view["groups"][0]["cross"]["v"]["A"]
    assert a.data_ptr() == pool.pooled["groups"][0]["cross"]["v"]["A"].data_ptr()
    assert torch.equal(a[:, 0], pair["tl"]["groups"][0]["cross"]["v"]["A"])
    update = tree_map(torch.ones_like, pair["tl"])
    new = pool.publish_round("t", pair["tl"], update, lr=0.5)
    assert torch.equal(pool.pooled["groups"][0]["cross"]["q"]["B"][0],
                       new["groups"][0]["cross"]["q"]["B"])
    assert torch.equal(new["groups"][0]["cross"]["q"]["B"],
                       pair["tl"]["groups"][0]["cross"]["q"]["B"] + 0.5)


def test_serve_batch_matches_jax(pair):
    """Tenants 0, 1, 2, 0 through the scheduler and the pool, the frames drawn
    from one seed in both packages: prefill and decode logits."""
    jcfg, cfg, gen = pair["jcfg"], pair["cfg"], 4
    rng = np.random.default_rng(9)
    template = jinit_lora(jax.random.PRNGKey(1), jcfg)
    trees = [jax.tree_util.tree_map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(
        np.float32), template) for _ in range(3)]
    jpool = JPool(template, 4)
    pool = AdapterPool(from_jax_tree(jax.tree_util.tree_map(np.asarray, template)), 4)
    prompts = rng.integers(0, cfg.vocab_size, size=(4, 12)).astype(np.int32)
    jsched = jserve.RequestScheduler(jpool, 4)
    tsched = serve.RequestScheduler(pool, 4)
    for i, t in enumerate(trees):
        jpool.publish(f"tenant-{i}", jax.tree_util.tree_map(jnp.asarray, t))
        pool.publish(f"tenant-{i}", from_jax_tree(t))
    for i in range(4):
        jsched.submit(jserve.Request(i, f"tenant-{i % 3}", prompts[i]))
        tsched.submit(serve.Request(i, f"tenant-{i % 3}", prompts[i]))
    jlogs, tlogs = [], []

    def rec(fn, out):
        def wrapped(*args):
            logits, caches = fn(*args)
            out.append(np.asarray(logits) if not torch.is_tensor(logits) else logits.numpy())
            return logits, caches
        return wrapped

    jpre, jdec = jserve.make_serving_fns(jcfg)
    tpre, tdec = serve.make_serving_fns(cfg)
    jserve.serve_batch(pair["jp"], jpool, jsched, jcfg, gen=gen, rng=np.random.default_rng(0),
                       prefill_fn=rec(jpre, jlogs), decode_fn=jdec)
    before = lm.gathered_lora_matmul.launches
    _, tokens = serve.serve_batch(pair["model"], pool, tsched, cfg, gen=gen,
                                  rng=np.random.default_rng(0), prefill_fn=rec(tpre, tlogs),
                                  decode_fn=tdec)
    assert lm.gathered_lora_matmul.launches == before  # the CPU takes the plain version
    assert tokens.shape == (4, gen)
    close(tlogs[0], jlogs[0], LOGIT_RTOL, "prefill logits")


def test_serve_cli_runs_on_the_cpu():
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "3",
                      "--prompt-len", "10", "--gen", "3", "--n-adapters", "2"])
    assert out.shape == (3, 3)
    out = serve.main(["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "10", "--gen", "3", "--n-adapters", "2", "--merged"])
    assert out.shape == (2, 3)


@pytest.mark.parametrize("optimizer", ["sgd", "adam"])
def test_local_step_with_frames_matches_jax(pair, optimizer):
    """One local phase of 2 clients x 2 sequences with ``encoder_frames``
    (M, per, S_enc, D) on the client axis, against the reference's vmapped
    ``make_local_step``; then a FedRPCA round (``make_fed_train_step``), as
    ``tests/test_arch_smoke.py::test_fed_train_step`` runs it."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    rng = np.random.default_rng(10)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 2, 17))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy(),
             "encoder_frames": rng.normal(size=(2, 2, cfg.encoder_seq, cfg.d_model)).astype(
                 np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.as_tensor(v) for k, v in batch.items()}
    kw = dict(local_lr=1e-2, local_steps=2, local_optimizer=optimizer, remat=False)
    jd, jloss_, _ = jax.jit(jsteps.make_local_step(jcfg, **kw))(pair["jp"], pair["jl"], jbatch)
    td, tloss, _ = steps.make_local_step(cfg, **kw)(pair["model"], pair["tl"], tbatch)
    np.testing.assert_allclose(float(tloss), float(jloss_), rtol=1e-5)
    for g, w in zip(tree_leaves(td), jax.tree_util.tree_leaves(jd)):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= STATE_FRO_RTOL * np.linalg.norm(w)
        if optimizer == "sgd":
            assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()
    if optimizer == "sgd":
        agg = dict(method="fedrpca", rpca_iters=10)
        jnew, jm = jsteps.make_fed_train_step(jcfg, JConfig(**agg), local_lr=1e-3,
                                              remat=False)(pair["jp"], pair["jl"], jbatch)
        tnew, tm = steps.make_fed_train_step(cfg, AggregatorConfig(**agg), local_lr=1e-3,
                                             remat=False)(pair["model"], pair["tl"], tbatch)
        np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
        for g, w, l0 in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew),
                            tree_leaves(pair["tl"])):
            w = np.asarray(w)
            assert np.abs(w - l0.numpy()).max() > 0  # the round moved every leaf
            np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)
