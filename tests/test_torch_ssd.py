"""The port's Mamba-2 path against the JAX package, on the CPU in float32:
the SSD scan's plain version, ``ssd_chunked`` (output and final state),
the SSD mixer in prefill and decode, a reduced Mamba-2-130M forward on the
same weights (``convert.model_from_jax``), multi-tenant ``serve_batch``
through the pool, and ``ops.soft_threshold`` at ranks 1 to 3.

Tolerances: the scans and ``ssd_chunked`` are held to the JAX suite's own
bound for chunked against sequential SSD, atol 5e-5 and rtol 1e-3
(tests/test_models.py); the mixer's output sums d_inner products after the
scan, 1e-5 of its largest value; logits 2e-5 of the largest logit (2
layers of fp32 sums in other orders), as for StableLM, except through the
pool: there the tenants' adapters (0.3 x N(0, 1) entries) make the first
decode step ill-conditioned, and the reference's own float32 logits lie
6.0e-5 of the largest logit from its float64 run (the port's 5.9e-6), so
the bound is 1e-4.  The soft threshold is elementwise with the same
roundings in both packages: equal bits.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.launch import serve as jserve
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import ssd as jssd
from repro.serve import AdapterPool as JPool
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.kernels import ops, ref
from repro_torch.launch import serve
from repro_torch.models import kvcache, ssd
from repro_torch.serve import AdapterPool
from repro_torch.utils.pytree import tree_leaves

ARCH = "mamba2-130m"
SCAN_TOL = dict(atol=5e-5, rtol=1e-3)
LOGIT_RTOL = 2e-5
POOL_LOGIT_RTOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def scan_inputs(seed, bh, s, p, n, decay, groups=None):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    g = groups or bh
    da = -(decay * rng.random((bh, s))).astype(np.float32)
    return f(bh, s, p), da, f(g, s, n), f(g, s, n)


@pytest.mark.parametrize("s,chunk,decay", [(64, 16, 0.1), (100, 32, 0.1), (37, 256, 1.0),
                                           (80, 16, 1e-3)])
def test_ssd_scan_plain_matches_jax(s, chunk, decay):
    """S past a chunk multiple, several chunks, strong and weak decay."""
    x, da, b, c = scan_inputs(0, 3, s, 16, 8, decay)
    got = ops.ssd_scan(T(x), T(da), T(b), T(c), chunk=chunk)
    want = jref.ssd_scan_ref(jnp.asarray(x), jnp.asarray(da), jnp.asarray(b), jnp.asarray(c),
                             chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **SCAN_TOL)
    pallas = jops.ssd_scan(jnp.asarray(x), jnp.asarray(da), jnp.asarray(b), jnp.asarray(c),
                           chunk=chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), **SCAN_TOL)


def test_ssd_scan_groups_and_state():
    """b and c as one group per batch row give the per-row result; the
    final state is the scan's h after the last position (zero input adds
    nothing), and ``h0`` continues a split sequence exactly."""
    bsz, h = 2, 3
    x, da, b, c = scan_inputs(1, bsz * h, 40, 8, 4, 0.2, groups=bsz)
    y, hf = ops.ssd_scan(T(x), T(da), T(b), T(c), return_state=True)
    rep = lambda a: T(np.repeat(a, h, axis=0))
    y_rows, hf_rows = ops.ssd_scan(T(x), T(da), rep(b), rep(c), return_state=True)
    torch.testing.assert_close(y, y_rows, atol=0, rtol=0)
    torch.testing.assert_close(hf, hf_rows, atol=0, rtol=0)
    assert hf.shape == (bsz * h, 4, 8) and hf.dtype == torch.float32
    y1, h1 = ref.ssd_scan_ref(T(x[:, :25]), T(da[:, :25]), T(b[:, :25]), T(c[:, :25]),
                              return_state=True)
    y2, h2 = ref.ssd_scan_ref(T(x[:, 25:]), T(da[:, 25:]), T(b[:, 25:]), T(c[:, 25:]),
                              h0=h1, return_state=True)
    torch.testing.assert_close(torch.cat([y1, y2], 1), y, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h2, hf, atol=1e-5, rtol=1e-5)


def chunked_inputs(seed, bsz, s, h, p, n):
    rng = np.random.default_rng(seed)
    f = lambda *sh: rng.normal(size=sh).astype(np.float32)
    dt = (np.abs(f(bsz, s, h)) * 0.1 + 0.01).astype(np.float32)
    a_log = np.log(np.linspace(1.0, 4.0, h)).astype(np.float32)
    return f(bsz, s, h, p), dt, a_log, f(bsz, s, n), f(bsz, s, n), f(h), f(bsz, h, p, n)


@pytest.mark.parametrize("s,chunk,with_init", [(64, 16, False), (50, 16, False),
                                               (50, 16, True)])
def test_ssd_chunked_matches_jax(s, chunk, with_init):
    x, dt, a_log, bm, cm, d, h0 = chunked_inputs(2, 2, s, 3, 8, 4)
    init = (T(h0), jnp.asarray(h0)) if with_init else (None, None)
    y, final = ssd.ssd_chunked(T(x), T(dt), T(a_log), T(bm), T(cm), T(d), chunk, init[0])
    jy, jfinal = jssd.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm, d)), chunk,
                                  init[1])
    assert y.shape == x.shape and final.shape == (2, 3, 8, 4)
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **SCAN_TOL)


@pytest.mark.parametrize("return_state", [True, False])
def test_ssd_chunked_h_init_matches_jax(return_state):
    """``h_init`` on the port's scan path (the kernel's plain version here):
    y, and the final state with ``return_state``, against the reference;
    without it the port returns no state."""
    x, dt, a_log, bm, cm, d, h0 = chunked_inputs(4, 2, 70, 3, 8, 4)
    y, final = ssd.ssd_chunked(T(x), T(dt), T(a_log), T(bm), T(cm), T(d), 16, T(h0),
                               return_state=return_state)
    jy, jfinal = jssd.ssd_chunked(*(jnp.asarray(a) for a in (x, dt, a_log, bm, cm, d)), 16,
                                  jnp.asarray(h0))
    np.testing.assert_allclose(y.numpy(), np.asarray(jy), **SCAN_TOL)
    if return_state:
        np.testing.assert_allclose(final.numpy(), np.asarray(jfinal), **SCAN_TOL)
    else:
        assert final is None


def test_ssd_chunked_h_init_grad_matches_jax():
    """The gradient of <y, gy> + <final, gh> in h_init, x and dt through the
    port's autograd Function (its backward differentiates the plain chunked
    form) against ``jax.grad`` of the reference's ``ssd_chunked``; the
    scans' bound."""
    x, dt, a_log, bm, cm, d, h0 = chunked_inputs(5, 2, 50, 3, 8, 4)
    rng = np.random.default_rng(6)
    gy = rng.normal(size=x.shape).astype(np.float32)
    gh = rng.normal(size=h0.shape).astype(np.float32)

    def jloss(hi, xi, dti):
        y, f = jssd.ssd_chunked(xi, dti, jnp.asarray(a_log), jnp.asarray(bm), jnp.asarray(cm),
                                jnp.asarray(d), 16, hi)
        return jnp.sum(y * gy) + jnp.sum(f * gh)

    want = jax.grad(jloss, argnums=(0, 1, 2))(jnp.asarray(h0), jnp.asarray(x), jnp.asarray(dt))
    live = [T(a).requires_grad_() for a in (h0, x, dt)]
    y, f = ssd.ssd_chunked(live[1], live[2], T(a_log), T(bm), T(cm), T(d), 16, live[0])
    loss = torch.sum(y * T(gy)) + torch.sum(f * T(gh))
    got = torch.autograd.grad(loss, live)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), **SCAN_TOL)


def jax_to_mixer(jparams, cfg):
    mixer = ssd.init_ssd(None, cfg, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        for name, p in mixer.named_parameters():
            node = jparams
            for key in name.split("."):
                node = node[key]
            p.copy_(T(node))
    return mixer


@pytest.fixture(scope="module")
def reduced():
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    return jcfg, cfg


def test_apply_ssd_prefill_then_decode_matches_jax(reduced):
    """The mixer with LoRA on in_proj and out_proj: a prefill of 21 tokens
    (state and conv window), then 3 decode steps that write the state in
    place."""
    jcfg, cfg = reduced
    jp = jssd.init_ssd(jax.random.PRNGKey(0), jcfg)
    mixer = jax_to_mixer(jp, cfg)
    rng = np.random.default_rng(3)
    dims = ssd.lora_dims(cfg)
    lora = {t: {"A": (0.2 * rng.normal(size=(d_in, 4))).astype(np.float32),
                "B": (0.2 * rng.normal(size=(4, d_out))).astype(np.float32)}
            for t, (d_in, d_out) in dims.items()}
    jl = jax.tree_util.tree_map(jnp.asarray, lora)
    tl = from_jax_tree(lora)
    x = rng.normal(size=(2, 21 + 3, cfg.d_model)).astype(np.float32)
    jout, jstate = jssd.apply_ssd(jp, jl, jnp.asarray(x[:, :21]), jcfg, lora_scale=2.0,
                                  return_state=True)
    out, state = ssd.apply_ssd(mixer, tl, T(x[:, :21]), cfg, lora_scale=2.0, return_state=True)
    tol = lambda w: dict(atol=1e-5 * float(np.abs(w).max()), rtol=0)
    np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol(jout))
    np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **SCAN_TOL)
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(jstate.conv), **tol(jstate.conv))
    state = kvcache.SSMState(h=state.h.contiguous(), conv=state.conv)
    ptrs = (state.h.data_ptr(), state.conv.data_ptr())
    for i in range(21, 24):
        jout, jstate = jssd.apply_ssd(jp, jl, jnp.asarray(x[:, i:i + 1]), jcfg, state=jstate,
                                      lora_scale=2.0)
        out, new = ssd.apply_ssd(mixer, tl, T(x[:, i:i + 1]), cfg, state=state, lora_scale=2.0)
        assert new is state and (state.h.data_ptr(), state.conv.data_ptr()) == ptrs
        np.testing.assert_allclose(out.numpy(), np.asarray(jout), **tol(jout))
        np.testing.assert_allclose(state.h.numpy(), np.asarray(jstate.h), **SCAN_TOL)


def test_short_prompt_pads_the_conv_window(reduced):
    """A prompt shorter than the conv width K - 1 leaves zeros in front, as
    the reference pads it."""
    jcfg, cfg = reduced
    jp = jssd.init_ssd(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(4).normal(size=(1, 2, cfg.d_model)).astype(np.float32)
    _, jstate = jssd.apply_ssd(jp, None, jnp.asarray(x), jcfg, return_state=True)
    _, state = ssd.apply_ssd(jax_to_mixer(jp, cfg), None, T(x), cfg, return_state=True)
    assert state.conv.shape == (1, cfg.conv_width - 1, ssd.ssd_dims(cfg)["conv_dim"])
    assert float(state.conv[:, 0].abs().max()) == 0.0
    np.testing.assert_allclose(state.conv.numpy(), np.asarray(jstate.conv), atol=1e-5, rtol=0)


@pytest.fixture(scope="module")
def pair(reduced):
    """Reduced Mamba-2 in both packages on the same weights, and a LoRA
    tree with nonzero B."""
    jcfg, cfg = reduced
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32),
        jinit_lora(jax.random.PRNGKey(1), jcfg),
    )
    tl = from_jax_tree(jax.tree_util.tree_map(np.asarray, jl))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, model=model, jl=jl, tl=tl)


def test_init_layouts_match_reference(pair):
    """Parameter count and dtypes, LoRA tree layout, and caches: the SSM
    state is never padded by ``extend_caches``."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    model = models.init_params(cfg.replace(dtype="bfloat16"), seed=3, device="cpu")
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(pair["jp"]))
    assert models.model.param_count(model) == n_ref
    mixer = model.layers[0].mixer
    assert mixer.in_proj["w"].dtype == mixer.norm["scale"].dtype == torch.bfloat16
    assert {mixer[k].dtype for k in ("A_log", "dt_bias", "D")} == {torch.float32}
    assert not hasattr(model.layers[0], "ffn")
    lora = models.init_lora_params(cfg, seed=3, device="cpu")
    jshapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jinit_lora(
        jax.random.PRNGKey(0), jcfg))]
    assert [tuple(x.shape) for x in tree_leaves(lora)] == jshapes
    caches = models.init_decode_caches(cfg, 2, 9, device="cpu")
    state = caches["groups"][0]["self"]
    dims = ssd.ssd_dims(cfg)
    assert isinstance(state, kvcache.SSMState)
    assert state.h.shape == (cfg.n_layers, 2, dims["n_heads"], dims["head_dim"], dims["state"])
    assert state.conv.shape == (cfg.n_layers, 2, cfg.conv_width - 1, dims["conv_dim"])
    ext = models.extend_caches(caches, 3, cfg)
    assert ext["groups"][0]["self"] is state


@pytest.mark.parametrize("adapter", ["none", "single"])
def test_forward_prefill_and_decode_match_jax(pair, adapter):
    """A 2-layer reduced Mamba-2 through ``model_from_jax``: prefill logits
    and caches, then 3 greedy decode steps."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    jl, tl = (None, None) if adapter == "none" else (pair["jl"], pair["tl"])
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, 37)).astype(np.int32)
    jlog, jc, _ = jforward(pair["jp"], jl, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill",
                           remat=False)
    tlog, tc, _ = models.forward(pair["model"], tl, {"tokens": T(toks).long()}, cfg,
                                 mode="prefill")
    tol = LOGIT_RTOL * float(np.abs(np.asarray(jlog)).max())
    assert tlog.shape == (3, 1, cfg.vocab_size) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    jc, tc = jextend(jc, 3, jcfg), models.extend_caches(tc, 3, cfg)
    np.testing.assert_allclose(tc["groups"][0]["self"].h.numpy(),
                               np.asarray(jc["groups"][0]["self"].h), **SCAN_TOL)
    tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
    for i in range(3):
        jlog, jc = jdecode(pair["jp"], jl, jnp.asarray(tok), jc, jnp.asarray(37 + i), jcfg)
        tlog, tc = models.decode_step(pair["model"], tl, T(tok).long(), tc, 37 + i, cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
        tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)


def test_decode_after_prefill_equals_longer_prefill(pair):
    """The state handoff: decoding token S+1 from a prefill of S tokens
    gives the logits of a prefill of S+1 tokens."""
    cfg, model, tl = pair["cfg"], pair["model"], pair["tl"]
    toks = T(np.random.default_rng(6).integers(0, cfg.vocab_size, size=(2, 30))).long()
    _, caches, _ = models.forward(model, tl, {"tokens": toks[:, :29]}, cfg, mode="prefill")
    step, _ = models.decode_step(model, tl, toks[:, 29:], caches, 29, cfg)
    whole, _, _ = models.forward(model, tl, {"tokens": toks}, cfg, mode="prefill")
    torch.testing.assert_close(step, whole, rtol=0,
                               atol=LOGIT_RTOL * float(whole.abs().max()))


@pytest.fixture(scope="module")
def served(pair):
    """Three tenant adapters (nonzero B) published in both pools."""
    template = jinit_lora(jax.random.PRNGKey(1), pair["jcfg"])
    rng = np.random.default_rng(2)
    trees = [jax.tree_util.tree_map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32),
                                    template) for _ in range(3)]
    jpool = JPool(template, 4)
    pool = AdapterPool(from_jax_tree(jax.tree_util.tree_map(np.asarray, template)), 4)
    for i, t in enumerate(trees):
        jpool.publish(f"tenant-{i}", jax.tree_util.tree_map(jnp.asarray, t))
        pool.publish(f"tenant-{i}", from_jax_tree(t))
    prompts = rng.integers(0, pair["cfg"].vocab_size, size=(4, 12)).astype(np.int32)
    return dict(pair, jpool=jpool, pool=pool, prompts=prompts)


def recorder(fn, out):
    def wrapped(*args):
        logits, caches = fn(*args)
        out.append(np.asarray(logits, np.float32) if not torch.is_tensor(logits)
                   else logits.numpy())
        return logits, caches
    return wrapped


def test_serve_batch_through_the_pool_matches_jax(served):
    """A mixed-tenant batch (tenants 0, 1, 2, 0) through the scheduler and
    the pool: every step's logits as the reference's on the same adapters,
    and greedy tokens from them."""
    jcfg, cfg, gen, prompts = served["jcfg"], served["cfg"], 4, served["prompts"]
    jsched = jserve.RequestScheduler(served["jpool"], 4)
    tsched = serve.RequestScheduler(served["pool"], 4)
    for i in range(4):
        jsched.submit(jserve.Request(i, f"tenant-{i % 3}", prompts[i]))
        tsched.submit(serve.Request(i, f"tenant-{i % 3}", prompts[i]))
    jlogs, tlogs = [], []
    jpre, jdec = jserve.make_serving_fns(jcfg)
    tpre, tdec = serve.make_serving_fns(cfg)
    _, jtokens = jserve.serve_batch(served["jp"], served["jpool"], jsched, jcfg, gen=gen,
                                    rng=np.random.default_rng(0),
                                    prefill_fn=recorder(jpre, jlogs),
                                    decode_fn=recorder(jdec, jlogs))
    _, tokens = serve.serve_batch(served["model"], served["pool"], tsched, cfg, gen=gen,
                                  prefill_fn=recorder(tpre, tlogs), decode_fn=recorder(tdec, tlogs))
    tol = POOL_LOGIT_RTOL * float(np.abs(jlogs[0]).max())
    assert len(tlogs) == len(jlogs) == gen
    for t_, j_ in zip(tlogs, jlogs):
        np.testing.assert_allclose(t_, j_, atol=tol, rtol=0)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


@pytest.mark.parametrize("merged", [False, True])
def test_main_serves_mamba_on_the_cpu(merged):
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "8",
            "--gen", "3", "--n-adapters", "2", "--pool-slots", "4"] + (["--merged"] if merged
                                                                      else [])
    out = serve.main(argv)
    assert out.shape == (3, 3) and out.device.type == "cpu"


def test_main_mamba_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--reduced"])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(37,), (5, 13), (3, 4, 7)])
def test_soft_threshold_matches_jax(shape, dtype):
    """``ops.soft_threshold`` against the reference's Pallas kernel in
    interpret mode, at ranks 1 to 3, with t a float and a 0-d tensor."""
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    jx = jnp.asarray(x, dtype)
    tx = T(x).to(getattr(torch, dtype))
    for t in (0.4, torch.tensor(0.25)):
        got = ops.soft_threshold(tx, t)
        want = jops.soft_threshold(jx, float(t), interpret=True)
        assert got.shape == shape and got.dtype == tx.dtype
        np.testing.assert_array_equal(got.float().numpy(), np.asarray(want, np.float32))
