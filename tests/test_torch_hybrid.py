"""The port's RecurrentGemma path (the hybrid of RG-LRU and sliding-window
attention) against the JAX package, on the CPU: ``rglru_scan`` against the
reference and a sequential loop, the RG-LRU block in prefill and decode,
the tanh GELU, GeGLU and ``embed_scale`` in float32 and bf16, windowed
attention (the prefill ring and ring decode), whole models through
``convert.model_from_jax`` (the reduced ``recurrentgemma-2b`` and the
reference's 5-layer ``hybrid`` test family, whose two tail layers are
covered so): train-mode logits and ``loss_fn``, prefill and decode;
the ring cache at prompts shorter and longer than the window; FedRPCA on a
LoRA tree with tail leaves; the pool and ``serve_batch``; and the CLI.

Tolerances, float32 unless named:
* ``rglru_scan``: the doubling passes add in another order than the loop
  and ``lax.associative_scan``; 1e-6 of the largest |h| per pass (12
  passes at S = 2560; here up to 9).
* The RG-LRU block and windowed attention: 1e-5 of the largest output
  (sums of d_model and lru_width products, and the scan, in other orders).
* Logits: 5e-5 of the largest logit (3-5 layers of such sums; StableLM's
  2-layer bound is 2e-5), and ``loss_fn`` 1e-5 relative.
* bf16: the embedding scale bit for bit (both round one product).  The
  tanh GELU within 2^-6 |x| of each input x: the port rounds its fp32
  result once, the reference rounds each bf16 step of the tanh form (1.3
  bf16 ulps of |x| measured apart); GeGLU's bf16 products and sums 2^-6 of
  the largest output.
"""
import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.core import AggregatorConfig as JAggConfig
from repro.core import aggregate as jaggregate
from repro.launch import serve as jserve
from repro.launch import steps as jsteps
from repro.models import attention as jattention
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import ffn as jffn
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import loss_fn as jloss
from repro.models import model as jmodel
from repro.models import rglru as jrglru
from repro.serve import AdapterPool as JPool
from repro_torch import config as tconfig
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.core import AggregatorConfig, aggregate
from repro_torch.launch import serve, steps
from repro_torch.models import attention, blocks, ffn, kvcache, layers, rglru
from repro_torch.serve import AdapterPool
from repro_torch.utils.pytree import tree_leaves, tree_map

ARCH = "recurrentgemma-2b"
SCAN_RTOL_PER_PASS = 1e-6
BLOCK_RTOL = 1e-5
LOGIT_RTOL = 5e-5
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def port_cfg(jcfg):
    """The port's ModelConfig with every field of the reference's."""
    d = dataclasses.asdict(jcfg)
    d["lora"] = tconfig.LoRAConfig(**d["lora"])
    return tconfig.ModelConfig(**d)


def hybrid_family():
    """tests/test_models.py's ``hybrid`` family: 5 layers of (rglru, rglru,
    local_attn), window 8, kv = 1, SwiGLU."""
    return jconfig.ModelConfig(
        name="hybrid", arch_type="dense", n_layers=5, d_model=64, n_heads=4, n_kv_heads=1,
        d_ff=128, vocab_size=97, dtype="float32", lora=jconfig.LoRAConfig(rank=4),
        layer_pattern=("rglru", "rglru", "local_attn"), lru_width=64, window_size=8)


def copy_params(module, jparams):
    """Write the reference's pytree node into a port module by parameter
    name (``lambda`` included)."""
    with torch.no_grad():
        for name, p in module.named_parameters():
            node = jparams
            for key in name.split("."):
                node = node[key]
            p.copy_(T(np.asarray(node, np.float32)))  # bf16 leaves pass exactly
    return module


def close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


# --- config --------------------------------------------------------------------

def test_config_matches_reference_and_builds_at_full_width():
    """Field for field, reduced too; the full model's blocks (26 layers, of
    which 2 are tail layers) and parameter count, built unfilled on the meta
    device."""
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jconfigs.get_config(ARCH))
    assert (dataclasses.asdict(get_config(ARCH).reduced())
            == dataclasses.asdict(jconfigs.get_config(ARCH).reduced()))
    cfg = get_config(ARCH)
    assert (cfg.n_pattern_groups, cfg.n_tail_layers) == (8, 2)
    model = models.DecoderLM(cfg, None, device="meta")
    kinds = [blk.kind for blk in model.layers]
    assert len(kinds) == 26 and kinds[24:] == ["rglru", "rglru"]
    assert kinds.count("local_attn") == 8
    want = jax.eval_shape(lambda k: jinit(k, jconfigs.get_config(ARCH)), jax.random.PRNGKey(0))
    assert models.model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("change", [dict(frontend="audio"), dict(encoder_decoder=True),
                                    dict(mrope=True), dict(kv_quant=True),
                                    dict(ffn_kind="gelu"), dict(frontend="vision")])
def test_check_ported_still_refuses(change):
    """The audio and vision frontends, cross-attention, M-RoPE, the int8
    cache and the GELU MLP each build on the reduced RecurrentGemma config,
    each leaf of the reference's tree
    carried into the port's model (``model_from_jax`` checks every shape)
    with the reference's parameter count, and its LoRA tree has the
    reference's leaves."""
    cfg = get_config(ARCH).reduced().replace(**change)
    jcfg = jconfigs.get_config(ARCH).reduced().replace(**change)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    assert models.model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(jp))
    jl = jax.eval_shape(lambda k: jinit_lora(k, jcfg), jax.random.PRNGKey(1))
    tl = models.init_lora_params(cfg, device="cpu")
    assert [tuple(x.shape) for x in tree_leaves(tl)] == [
        tuple(x.shape) for x in jax.tree_util.tree_leaves(jl)]


# --- the RG-LRU block ---------------------------------------------------------------

@pytest.mark.parametrize("s", [1, 32, 100, 300])
def test_rglru_scan_matches_jax_and_a_loop(s):
    rng = np.random.default_rng(s)
    a = rng.uniform(0.8, 0.999, size=(2, s, 8)).astype(np.float32)
    b = rng.normal(size=(2, s, 8)).astype(np.float32)
    got = rglru.rglru_scan(T(a), T(b)).numpy()
    want = jax.jit(jrglru.rglru_scan)(jnp.asarray(a), jnp.asarray(b), None)
    h = np.zeros((2, 8), np.float32)
    loop = []
    for t in range(s):
        h = a[:, t] * h + b[:, t]
        loop.append(h.copy())
    passes = max(1, math.ceil(math.log2(s)))
    close(got, want, SCAN_RTOL_PER_PASS * passes, "vs reference")
    close(got, np.stack(loop, axis=1), SCAN_RTOL_PER_PASS * passes, "vs loop")


def old_doubling_scan(a, b):
    """The serving scan as slice 10 shipped it, kept here verbatim so that
    its bits stay pinned."""
    s = a.shape[1]
    a = a.transpose(0, 1).contiguous()
    b = b.transpose(0, 1).contiguous()
    shift = 1
    while shift < s:
        na, nb = torch.empty_like(a), torch.empty_like(b)
        nb[:shift] = b[:shift]
        torch.addcmul(b[shift:], a[shift:], b[:-shift], out=nb[shift:])
        na[:shift] = a[:shift]
        torch.mul(a[shift:], a[:-shift], out=na[shift:])
        a, b = na, nb
        shift *= 2
    return b.transpose(0, 1)


@pytest.mark.parametrize("s", [1, 2, 7, 33])
def test_rglru_scan_gradients_are_the_reverse_scan(s):
    """The scan's Function in float64: ``gradcheck`` against finite
    differences, and its gradients against autograd through a sequential
    loop (1e-12 of the largest: the same products summed in another
    order)."""
    gen = torch.Generator().manual_seed(s)
    a = (0.4 + 0.55 * torch.rand((2, s, 5), generator=gen, dtype=torch.float64))
    b = torch.randn((2, s, 5), generator=gen, dtype=torch.float64)
    a.requires_grad_()
    b.requires_grad_()
    assert torch.autograd.gradcheck(rglru.rglru_scan, (a, b))

    def loop(a_, b_):
        h, out = torch.zeros_like(a_[:, 0]), []
        for t in range(s):
            h = a_[:, t] * h + b_[:, t]
            out.append(h)
        return torch.stack(out, dim=1)

    g = torch.randn((2, s, 5), generator=gen, dtype=torch.float64)
    got = torch.autograd.grad(rglru.rglru_scan(a, b), (a, b), g)
    want = torch.autograd.grad(loop(a, b), (a, b), g)
    for x, y in zip(got, want):
        assert float((x - y).abs().max()) <= 1e-12 * float(y.abs().max())


@pytest.mark.parametrize("s", [1, 100, 300])
def test_rglru_scan_keeps_the_serving_bits(s):
    """No grad: the doubling passes' bits, as slice 10 shipped them; with
    grad: the Function's forward gives the same bits."""
    rng = np.random.default_rng(s + 7)
    a = T(rng.uniform(0.8, 0.999, size=(3, s, 16)).astype(np.float32))
    b = T(rng.normal(size=(3, s, 16)).astype(np.float32))
    want = old_doubling_scan(a, b)
    with torch.no_grad():
        assert torch.equal(rglru.rglru_scan(a, b), want)
    live = rglru.rglru_scan(a.clone().requires_grad_(), b)
    assert live.requires_grad and torch.equal(live.detach(), want)


@pytest.fixture(scope="module")
def reduced():
    jcfg = jconfigs.get_config(ARCH).reduced()
    return jcfg, get_config(ARCH).reduced()


def lora_for(dims, rng, rank=4):
    return {t: {"A": (0.2 * rng.normal(size=(d_in, rank))).astype(np.float32),
                "B": (0.2 * rng.normal(size=(rank, d_out))).astype(np.float32)}
            for t, (d_in, d_out) in dims.items()}


def test_apply_rglru_prefill_then_decode_matches_jax(reduced):
    """LoRA on proj_x and out_proj: a prefill of 21 tokens (h and the conv
    window), then 3 decode steps that write the state in place."""
    jcfg, cfg = reduced
    jp = jrglru.init_rglru(jax.random.PRNGKey(0), jcfg)
    mixer = copy_params(rglru.init_rglru(None, cfg, dtype=torch.float32, device="cpu"), jp)
    japply = jax.jit(jrglru.apply_rglru, static_argnums=3,
                     static_argnames=("lora_scale", "return_state"))
    rng = np.random.default_rng(3)
    lora = lora_for(rglru.lora_dims(cfg), rng)
    jl, tl = jax.tree_util.tree_map(jnp.asarray, lora), from_jax_tree(lora)
    x = rng.normal(size=(2, 24, cfg.d_model)).astype(np.float32)
    jout, jstate = japply(jp, jl, jnp.asarray(x[:, :21]), jcfg, lora_scale=2.0,
                          return_state=True)
    out, state = rglru.apply_rglru(mixer, tl, T(x[:, :21]), cfg, lora_scale=2.0,
                                   return_state=True)
    close(out.numpy(), jout, BLOCK_RTOL, "prefill out")
    close(state.h.numpy(), jstate.h, BLOCK_RTOL, "prefill h")
    close(state.conv.numpy(), jstate.conv, BLOCK_RTOL, "prefill conv")
    assert state.h.dtype == torch.float32
    # The state owns its memory: no view that keeps the prefill's buffers.
    for t in state:
        assert t.untyped_storage().nbytes() == t.numel() * t.element_size()
    ptrs = (state.h.data_ptr(), state.conv.data_ptr())
    for i in range(21, 24):
        jout, jstate = japply(jp, jl, jnp.asarray(x[:, i:i + 1]), jcfg, state=jstate,
                              lora_scale=2.0)
        out, new = rglru.apply_rglru(mixer, tl, T(x[:, i:i + 1]), cfg, state=state,
                                     lora_scale=2.0)
        assert new is state and (state.h.data_ptr(), state.conv.data_ptr()) == ptrs
        close(out.numpy(), jout, BLOCK_RTOL, f"decode {i}")
        close(state.h.numpy(), jstate.h, BLOCK_RTOL, f"decode h {i}")


def test_short_prompt_pads_the_conv_tail(reduced):
    """A prompt of 2 < K - 1 tokens leaves zeros in front of the conv
    window, as the reference pads it."""
    jcfg, cfg = reduced
    jp = jrglru.init_rglru(jax.random.PRNGKey(1), jcfg)
    x = np.random.default_rng(4).normal(size=(1, 2, cfg.d_model)).astype(np.float32)
    _, jstate = jrglru.apply_rglru(jp, None, jnp.asarray(x), jcfg, return_state=True)
    mixer = copy_params(rglru.init_rglru(None, cfg, dtype=torch.float32, device="cpu"), jp)
    _, state = rglru.apply_rglru(mixer, None, T(x), cfg, return_state=True)
    assert state.conv.shape == (1, cfg.conv_width - 1, rglru.lru_width(cfg))
    assert float(state.conv[:, 0].abs().max()) == 0.0
    close(state.conv.numpy(), jstate.conv, BLOCK_RTOL)


# --- GELU, GeGLU, embed_scale -------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_gelu_and_geglu_match_jax(dtype):
    rng = np.random.default_rng(5)
    x = (3.0 * rng.normal(size=(4, 7, 64))).astype(np.float32)
    tdt, jdt = getattr(torch, dtype), jnp.dtype(dtype)
    got = layers.gelu(T(x).to(tdt)).float().numpy()
    want = np.asarray(jlayers.gelu(jnp.asarray(x, jdt)), np.float32)
    if dtype == "float32":
        close(got, want, 1e-6)
    else:
        xb = T(x).bfloat16().double().numpy()
        assert np.all(np.abs(got - want) <= 2.0**-6 * np.abs(xb))
    jp = jffn.init_ffn(jax.random.PRNGKey(2), 64, 96, "geglu", dtype=jdt)
    tp = copy_params(ffn.init_ffn(None, 64, 96, "geglu", dtype=tdt, device="cpu"), jp)
    got = ffn.apply_ffn(tp, T(x).to(tdt), "geglu").float().numpy()
    want = np.asarray(jffn.apply_ffn(jp, jnp.asarray(x, jdt), "geglu"), np.float32)
    close(got, want, BLOCK_RTOL if dtype == "float32" else 2.0**-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_embed_scale_matches_jax(dtype):
    """sqrt(2560) rounded to the dtype first: 50.5 in bf16."""
    jcfg = jconfigs.get_config(ARCH).reduced().replace(d_model=2560, dtype=dtype)
    cfg = port_cfg(jcfg)
    emb = (0.02 * np.random.default_rng(6).normal(size=(cfg.vocab_size, 2560))).astype(np.float32)
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(2, 9))
    model = torch.nn.Module()
    model.embed = layers._param(T(emb).to(getattr(torch, dtype)))
    got = models.model.embed_tokens(model, T(toks).long(), cfg).float().numpy()
    want, _ = jmodel._embed_inputs({"embed": jnp.asarray(emb, jnp.dtype(dtype))},
                                   {"tokens": jnp.asarray(toks)}, jcfg, "train", None)
    np.testing.assert_array_equal(got, np.asarray(want, np.float32))
    if dtype == "bfloat16":
        ratio = got[emb[toks] != 0] / T(emb).bfloat16().float().numpy()[toks][emb[toks] != 0]
        np.testing.assert_allclose(ratio, 50.5, rtol=2.0**-8)


# --- windowed attention ---------------------------------------------------------------

def test_windowed_attention_ring_prefill_and_decode_match_jax(reduced):
    """A prompt of 40 >= window 32: the output, the ring (the last 32 keys
    rolled by 40 % 32), then 3 ring-decode steps written in place at slots
    8, 9, 10."""
    jcfg, cfg = reduced
    jp = jattention.init_attention(jax.random.PRNGKey(3), jcfg)
    tp = copy_params(attention.init_attention(None, cfg, dtype=torch.float32, device="cpu"), jp)
    japply = jax.jit(jattention.apply_attention, static_argnums=3,
                     static_argnames=("window", "return_cache"))
    rng = np.random.default_rng(8)
    lora = lora_for(blocks.lora_dims(cfg, "local_attn"), rng)
    jl, tl = jax.tree_util.tree_map(jnp.asarray, lora), from_jax_tree(lora)
    x = rng.normal(size=(2, 43, cfg.d_model)).astype(np.float32)
    pos = lambda a, b: np.broadcast_to(np.arange(a, b)[None], (2, b - a))
    w = cfg.window_size
    jout, jc = japply(jp, jl, jnp.asarray(x[:, :40]), jcfg, positions=jnp.asarray(pos(0, 40)),
                      window=w, return_cache=True)
    out, tc = attention.apply_attention(tp, tl, T(x[:, :40]), cfg, positions=T(pos(0, 40)),
                                        window=w, return_cache=True)
    close(out.numpy(), jout, BLOCK_RTOL, "prefill")
    assert tc.k.shape == (2, w, 1, cfg.head_dim_)
    close(tc.k.numpy(), jc.k, BLOCK_RTOL, "ring k")
    close(tc.v.numpy(), jc.v, BLOCK_RTOL, "ring v")
    ptr = tc.k.data_ptr()
    for i in range(40, 43):
        jout, jc = japply(jp, jl, jnp.asarray(x[:, i:i + 1]), jcfg,
                          positions=jnp.asarray(pos(i, i + 1)), window=w, cache=jc,
                          cache_index=jnp.asarray(i))
        out, new = attention.apply_attention(tp, tl, T(x[:, i:i + 1]), cfg,
                                             positions=T(pos(i, i + 1)), window=w, cache=tc,
                                             cache_index=i)
        assert new is tc and tc.k.data_ptr() == ptr
        close(out.numpy(), jout, BLOCK_RTOL, f"decode {i}")
        close(tc.k.numpy(), jc.k, BLOCK_RTOL, f"ring after {i}")


# --- whole models ------------------------------------------------------------------

FAMILIES = {
    "rg-reduced": lambda: jconfigs.get_config(ARCH).reduced(),
    "hybrid": hybrid_family,
}
# The reference's functions compiled once per shape: run op by op, their
# scans and layers take most of this file's time.
jforward = jax.jit(jforward, static_argnums=3, static_argnames=("mode", "remat"))
jdecode = jax.jit(jdecode, static_argnums=5)
jloss = jax.jit(jloss, static_argnums=3, static_argnames=("remat",))
jinit = jax.jit(jinit, static_argnums=1)
jinit_lora = jax.jit(jinit_lora, static_argnums=1)


@functools.lru_cache(maxsize=None)
def make_pair(name):
    """One family in both packages on the same weights, with a LoRA tree of
    nonzero B (tail leaves included)."""
    jcfg = FAMILIES[name]()
    cfg = port_cfg(jcfg)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32),
        jinit_lora(jax.random.PRNGKey(1), jcfg))
    tl = from_jax_tree(jax.tree_util.tree_map(np.asarray, jl))
    return dict(name=name, jcfg=jcfg, cfg=cfg, jp=jp, model=model, jl=jl, tl=tl)


@pytest.fixture(params=list(FAMILIES))
def pair(request):
    return make_pair(request.param)


def test_layouts_match_reference(pair):
    """Parameter count, LoRA tree and decode caches (tail entries, the ring
    sized min(window, cache_len), the LRU state) in the reference's
    layout."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(pair["jp"]))
    assert models.model.param_count(pair["model"]) == n_ref
    lora = models.init_lora_params(cfg, seed=3, device="cpu")
    jshapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(pair["jl"])]
    assert [tuple(x.shape) for x in tree_leaves(lora)] == jshapes
    assert len(lora["tail"]) == cfg.n_tail_layers
    for cache_len in (5, 3 * cfg.window_size):
        caches = models.init_decode_caches(cfg, 2, cache_len, device="cpu")
        jc = jmodel.init_decode_caches(jcfg, 2, cache_len)
        assert ([tuple(x.shape) for x in tree_leaves(caches)]
                == [tuple(x.shape) for x in jax.tree_util.tree_leaves(jc)])
        assert isinstance(caches["groups"][0]["self"], kvcache.LRUState)


def test_train_logits_and_loss_match_jax(pair):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    rng = np.random.default_rng(2)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 20))
    labels = rng.integers(0, cfg.vocab_size, size=(2, 20))
    labels[0, :3] = -1
    jb = {"tokens": jnp.asarray(toks), "labels": jnp.asarray(labels)}
    tb = {"tokens": T(toks).long(), "labels": T(labels).long()}
    jlog, _, _ = jforward(pair["jp"], pair["jl"], jb, jcfg, mode="train", remat=False)
    tlog, _, _ = models.forward(pair["model"], pair["tl"], tb, cfg, mode="train")
    close(tlog.numpy(), jlog, LOGIT_RTOL)
    jtotal, _ = jloss(pair["jp"], pair["jl"], jb, jcfg, remat=False)
    total, _ = models.loss_fn(pair["model"], pair["tl"], tb, cfg)
    assert abs(float(total) - float(jtotal)) <= LOSS_RTOL * abs(float(jtotal))


def test_lora_grads_with_tail_leaves_match_jax_and_remat():
    """Training through the hybrid family's tail layers: the LoRA gradients
    of ``loss_fn`` (group and tail leaves) against ``jax.value_and_grad``
    within ``GRAD_RTOL`` of each leaf's largest entry (fp32 sums through 5
    layers and the scan's passes), and ``remat=True`` giving the gradients
    of ``remat=False`` (the same operations replayed)."""
    pair = make_pair("hybrid")
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    rng = np.random.default_rng(12)
    toks = rng.integers(0, cfg.vocab_size, size=(3, 24))
    labels = rng.integers(0, cfg.vocab_size, size=(3, 24))
    (_, _), jg = jax.value_and_grad(
        lambda l: jloss(pair["jp"], l, {"tokens": jnp.asarray(toks),
                                        "labels": jnp.asarray(labels)}, jcfg, remat=False),
        has_aux=True)(pair["jl"])
    tb = {"tokens": T(toks).long(), "labels": T(labels).long()}
    grads = []
    for remat in (False, True):
        live = tree_map(lambda t: t.clone().requires_grad_(), pair["tl"])
        total, _ = models.loss_fn(pair["model"], live, tb, cfg, remat=remat)
        grads.append(torch.autograd.grad(total, tree_leaves(live)))
    assert len(pair["tl"]["tail"]) == 2
    for g, w in zip(grads[0], jax.tree_util.tree_leaves(jg)):
        close(g.numpy(), w, GRAD_RTOL, "LoRA gradient")
    for a, b in zip(*grads):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_local_step_with_tail_leaves_matches_jax():
    """One SGD local phase (3 clients x 2 x 12 tokens, 2 steps) of the hybrid
    family, tail leaves included, against the reference's vmapped phase:
    the loss within 1e-5 and every delta within 1e-4 of its leaf's
    largest."""
    pair = make_pair("hybrid")
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    toks = np.random.default_rng(13).integers(0, cfg.vocab_size, size=(3, 2, 13))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    kw = dict(local_lr=1e-1, local_steps=2, local_optimizer="sgd", remat=False)
    jd, jl_, _ = jax.jit(jsteps.make_local_step(jcfg, **kw))(
        pair["jp"], pair["jl"], {k: jnp.asarray(v) for k, v in batch.items()})
    td, tl_, _ = steps.make_local_step(cfg, **kw)(
        pair["model"], pair["tl"], {k: T(v).long() for k, v in batch.items()})
    assert abs(float(tl_) - float(jl_)) <= 1e-5 * abs(float(jl_))
    assert td["tail"][0]["mixer"]["q"]["A"].shape[0] == 3
    for g, w in zip(tree_leaves(td), jax.tree_util.tree_leaves(jd)):
        close(g.numpy(), w, 1e-4, "delta")


def decode_run(pair, toks, steps, package):
    """Prefill ``toks`` (B, P), extend the caches by ``steps`` and decode the
    next ``steps`` tokens of ``toks_all`` fed in; returns the logits of each
    decode step, (B, V) each."""
    cfg, jcfg, p = pair["cfg"], pair["jcfg"], toks.shape[1] - steps
    out = []
    if package == "jax":
        _, c, _ = jforward(pair["jp"], pair["jl"], {"tokens": jnp.asarray(toks[:, :p])}, jcfg,
                           mode="prefill", remat=False)
        c = jextend(c, steps, jcfg)
        for i in range(steps):
            lg, c = jdecode(pair["jp"], pair["jl"], jnp.asarray(toks[:, p + i:p + i + 1]), c,
                            jnp.asarray(p + i), jcfg)
            out.append(np.asarray(lg)[:, 0])
        return out
    _, c, _ = models.forward(pair["model"], pair["tl"], {"tokens": T(toks[:, :p]).long()}, cfg,
                             mode="prefill")
    c = models.extend_caches(c, steps, cfg)
    for i in range(steps):
        lg, c = models.decode_step(pair["model"], pair["tl"], T(toks[:, p + i:p + i + 1]).long(),
                                   c, p + i, cfg)
        out.append(lg.numpy()[:, 0])
    return out


def test_prefill_and_decode_match_jax_at_a_prompt_past_the_window(pair):
    """Prompt >= window (the ring wraps at prefill and again in decode):
    prefill logits and 4 decode steps as the reference's, and as the
    port's own train-mode forward over the same tokens."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    steps, p = 4, cfg.window_size + 3
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, p + steps))
    jlog, _, _ = jforward(pair["jp"], pair["jl"], {"tokens": jnp.asarray(toks[:, :p])}, jcfg,
                          mode="prefill", remat=False)
    tlog, _, _ = models.forward(pair["model"], pair["tl"], {"tokens": T(toks[:, :p]).long()},
                                cfg, mode="prefill")
    close(tlog.numpy(), jlog, LOGIT_RTOL, "prefill")
    got, want = decode_run(pair, toks, steps, "torch"), decode_run(pair, toks, steps, "jax")
    train, _, _ = models.forward(pair["model"], pair["tl"], {"tokens": T(toks).long()}, cfg,
                                 mode="train")
    for i, (g, w) in enumerate(zip(got, want)):
        close(g, w, LOGIT_RTOL, f"decode step {i}")
        close(g, train[:, p + i].numpy(), LOGIT_RTOL, f"decode step {i} vs train")


def test_ring_fault_short_prompt_decode_equals_train_forward(pair):
    """Prompt shorter than the window: the port's decode equals the
    reference's train-mode forward over the same tokens (its ring grows to
    min(window, prompt + steps)), where the reference's own decode, whose
    ring stays at the prompt's length, evicts keys still inside the window
    and departs (ROADMAP.md queue 3)."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    steps, p = 4, 4
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, p + steps))
    jtrain, _, _ = jforward(pair["jp"], pair["jl"], {"tokens": jnp.asarray(toks)}, jcfg,
                            mode="train", remat=False)
    jtrain = np.asarray(jtrain)
    got = decode_run(pair, toks, steps, "torch")
    for i, g in enumerate(got):
        close(g, jtrain[:, p + i], LOGIT_RTOL, f"decode step {i}")
    ref_decode = decode_run(pair, toks, steps, "jax")
    scale = float(np.abs(jtrain).max())
    port_err = [float(np.abs(g - jtrain[:, p + i]).max()) for i, g in enumerate(got)]
    ref_err = [float(np.abs(w - jtrain[:, p + i]).max()) for i, w in enumerate(ref_decode)]
    print(f"{pair['name']}, prompt {p}, window {cfg.window_size}: max |logit - train-mode "
          f"logit| per decode step, port {port_err}, reference {ref_err} (max |logit| {scale})")
    assert max(ref_err) > 100 * LOGIT_RTOL * scale, ref_err


# --- aggregation, the pool and serving ------------------------------------------------

def test_fedrpca_on_a_tree_with_tail_leaves_matches_jax():
    """Stacked client deltas of the hybrid family's LoRA tree (group leaves
    (C, n_groups, d_in, r), tail leaves (C, d_in, r)) through the packed
    engine at module granularity, against the reference's."""
    pair = make_pair("hybrid")
    rng = np.random.default_rng(5)
    core = rng.normal(size=(6, 2))
    tree = jax.tree_util.tree_map(
        lambda a: (np.moveaxis(rng.normal(size=a.shape + (2,)) @ core.T, -1, 0)
                   + 0.05 * rng.normal(size=(6,) + a.shape)).astype(np.float32),
        jax.tree_util.tree_map(np.asarray, pair["jl"]))
    kw = dict(method="fedrpca", rpca_iters=10)
    want = jaggregate(jax.tree_util.tree_map(jnp.asarray, tree), JAggConfig(**kw),
                      engine="packed")
    got = aggregate(from_jax_tree(tree), AggregatorConfig(**kw), engine="packed", device="cpu")
    scale = max(np.abs(x).max() for x in jax.tree_util.tree_leaves(tree))
    assert len(got["tail"]) == 2 and got["tail"][0]["mixer"]["q"]["A"].ndim == 2
    for g, w in zip(tree_leaves(got), jax.tree_util.tree_leaves(want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0, atol=1e-5 * scale)


def test_pool_publish_round_and_merged_with_tail_leaves():
    """The reduced RecurrentGemma at 5 layers (2 tail layers): the pool keeps
    tail leaves as (n_slots, d_in, r), publish writes them in place,
    ``publish_round`` applies an update to them, ``merged`` averages them
    over resident slots."""
    cfg = get_config(ARCH).reduced().replace(n_layers=5)
    template = models.init_lora_params(cfg, seed=0, device="cpu")
    pool = AdapterPool(template, 3)
    ptrs = [x.data_ptr() for x in tree_leaves(pool.pooled)]
    gen = torch.Generator().manual_seed(0)
    a = tree_map(lambda x: torch.randn(x.shape, generator=gen), template)
    b = tree_map(lambda x: 2.0 * x, a)
    pool.publish("a", a)
    pool.publish("b", b)
    tail_a = pool.pooled["tail"][0]["mixer"]["q"]["A"]
    assert tail_a.shape == (3,) + tuple(a["tail"][0]["mixer"]["q"]["A"].shape)
    torch.testing.assert_close(tail_a[1], b["tail"][0]["mixer"]["q"]["A"], atol=0, rtol=0)
    merged = pool.merged()
    for m, x in zip(tree_leaves(merged), tree_leaves(a)):
        torch.testing.assert_close(m, 1.5 * x, atol=1e-6, rtol=1e-6)
    upd = tree_map(lambda x: 0.5 * torch.ones_like(x), a)
    new = pool.publish_round("a", a, upd)
    torch.testing.assert_close(pool.pooled["tail"][1]["mixer"]["v"]["B"][0],
                               a["tail"][1]["mixer"]["v"]["B"] + 0.5, atol=0, rtol=0)
    assert [x.data_ptr() for x in tree_leaves(pool.pooled)] == ptrs
    assert tree_leaves(new)[0].shape == tree_leaves(a)[0].shape


def test_serve_batch_through_the_pool_matches_jax():
    """The reduced RecurrentGemma: a mixed-tenant batch (tenants 0, 1, 2, 0)
    through the scheduler and the pool at a prompt past the window: every
    step's logits as the reference's on the same adapters, and the same
    greedy tokens."""
    pair = make_pair("rg-reduced")
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    template = jinit_lora(jax.random.PRNGKey(1), jcfg)
    rng = np.random.default_rng(2)
    trees = [jax.tree_util.tree_map(lambda a: (0.3 * rng.normal(size=a.shape)).astype(np.float32),
                                    template) for _ in range(3)]
    jpool = JPool(template, 4)
    pool = AdapterPool(from_jax_tree(jax.tree_util.tree_map(np.asarray, template)), 4)
    for i, t in enumerate(trees):
        jpool.publish(f"tenant-{i}", jax.tree_util.tree_map(jnp.asarray, t))
        pool.publish(f"tenant-{i}", from_jax_tree(t))
    gen, p = 4, cfg.window_size + 8
    prompts = rng.integers(0, cfg.vocab_size, size=(4, p)).astype(np.int32)
    jsched, tsched = jserve.RequestScheduler(jpool, 4), serve.RequestScheduler(pool, 4)
    for i in range(4):
        jsched.submit(jserve.Request(i, f"tenant-{i % 3}", prompts[i]))
        tsched.submit(serve.Request(i, f"tenant-{i % 3}", prompts[i]))
    jlogs, tlogs = [], []

    def recorder(fn, out):
        def wrapped(*args):
            logits, caches = fn(*args)
            out.append(np.asarray(logits, np.float32) if not torch.is_tensor(logits)
                       else logits.numpy())
            return logits, caches
        return wrapped

    jpre, jdec = jserve.make_serving_fns(jcfg)
    tpre, tdec = serve.make_serving_fns(cfg)
    _, jtokens = jserve.serve_batch(pair["jp"], jpool, jsched, jcfg, gen=gen,
                                    rng=np.random.default_rng(0), prefill_fn=recorder(jpre, jlogs),
                                    decode_fn=recorder(jdec, jlogs))
    _, tokens = serve.serve_batch(pair["model"], pool, tsched, cfg, gen=gen,
                                  prefill_fn=recorder(tpre, tlogs), decode_fn=recorder(tdec, tlogs))
    assert len(tlogs) == len(jlogs) == gen
    for t_, j_ in zip(tlogs, jlogs):
        close(t_, j_, LOGIT_RTOL)
    np.testing.assert_array_equal(tokens.numpy(), np.asarray(jtokens))


@pytest.mark.parametrize("merged", [False, True])
def test_main_serves_recurrentgemma_on_the_cpu(merged):
    """The CLI at the reduced size, a prompt of 40 past the window of 32."""
    argv = ["--arch", ARCH, "--reduced", "--device", "cpu", "--batch", "3", "--prompt-len", "40",
            "--gen", "3", "--n-adapters", "2", "--pool-slots", "4"] + (["--merged"] if merged
                                                                      else [])
    out = serve.main(argv)
    assert out.shape == (3, 3) and out.device.type == "cpu"


def test_main_recurrentgemma_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        serve.main(["--arch", ARCH, "--reduced"])
