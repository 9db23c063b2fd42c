"""The port's decoder LM against the JAX package, on the CPU in float32:
configs, norms, RoPE, the dense + LoRA projection in its three adapter
forms, and prefill / decode logits of reduced StableLM-2-1.6B on the same
weights (carried across by ``convert.model_from_jax``).

Tolerances: a projection sums d_in products, taken in another order by each
library, so its error is held to 1e-6 * sqrt(d_in) of the largest output;
logits after 2 layers (sums of up to 512 terms, softmax, norms) to 2e-5 of
the largest logit; elementwise layers (norm, RoPE) to atol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import config as jconfig
from repro import configs as jconfigs
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro_torch import config as tconfig
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.models import attention, kvcache, layers
from repro_torch.utils.pytree import tree_leaves

ARCH = "stablelm-1.6b"
ELEM = dict(atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def pair():
    """Reduced StableLM in both packages on the same weights, and a LoRA
    tree with nonzero B."""
    jcfg = jconfigs.get_config(ARCH).reduced()
    cfg = get_config(ARCH).reduced()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32),
        jinit_lora(jax.random.PRNGKey(1), jcfg),
    )
    tl = from_jax_tree(jax.tree_util.tree_map(np.asarray, jl))
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, model=model, jl=jl, tl=tl)


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("arch", ["stablelm-1.6b", "mamba2-130m", "paper-vit-b32"])
def test_config_and_reduced_match_reference(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jconfigs.get_config(arch))
    assert (dataclasses.asdict(get_config(arch).reduced())
            == dataclasses.asdict(jconfigs.get_config(arch).reduced()))


@pytest.mark.parametrize("cls", ["ModelConfig", "LoRAConfig"])
def test_config_fields_match_reference_classes(cls):
    jf = [(f.name, f.default) for f in getattr(jconfig, cls).__dataclass_fields__.values()]
    tf = [(f.name, f.default) for f in getattr(tconfig, cls).__dataclass_fields__.values()]
    assert jf == tf


@pytest.mark.parametrize("arch,exc", [("whisper-medium", None), ("qwen2-vl-2b", None),
                                      ("no-such-arch", KeyError)])
def test_get_config_refuses_what_is_not_ported(arch, exc):
    """Every architecture of the reference resolves, each config equal to
    the reference's; only an unknown id is refused."""
    if exc is not None:
        with pytest.raises(exc):
            get_config(arch)
        return
    assert arch in jconfigs.ARCH_IDS
    for a in jconfigs.ARCH_IDS:
        assert dataclasses.asdict(get_config(a)) == dataclasses.asdict(jconfigs.get_config(a))


@pytest.mark.parametrize("kind", ["layernorm", "rmsnorm"])
def test_apply_norm_matches_jax(kind):
    rng = np.random.default_rng(2)
    x = rng.normal(3.0, 2.0, size=(2, 5, 64)).astype(np.float32)
    p = {"scale": rng.normal(size=64).astype(np.float32)}
    if kind == "layernorm":
        p["bias"] = rng.normal(size=64).astype(np.float32)
    got = layers.apply_norm({k: T(v) for k, v in p.items()}, T(x), 1e-5)
    want = jlayers.apply_norm({k: jnp.asarray(v) for k, v in p.items()}, jnp.asarray(x), 1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("pct", [0.25, 1.0])
def test_apply_rope_matches_jax(pct):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(2, 7, 3, 32)).astype(np.float32)
    pos = np.broadcast_to(np.arange(7) + 5, (2, 7)).astype(np.int32)
    got = layers.apply_rope(T(x), T(pos), 10_000.0, pct)
    want = jlayers.apply_rope(jnp.asarray(x), jnp.asarray(pos), 10_000.0, pct)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("form", ["none", "single", "batched"])
def test_dense_matches_jax(form):
    rng = np.random.default_rng(4)
    f = lambda *s: rng.normal(size=s).astype(np.float32)
    x, w, bias = f(3, 5, 48), f(48, 40) / np.float32(7.0), f(40)
    lora = None
    if form == "single":
        lora = {"A": f(48, 4), "B": f(4, 40)}
    elif form == "batched":
        lora = {"A": f(3, 48, 4), "B": f(3, 4, 40)}
    got = layers.dense(T(x), {"w": T(w), "b": T(bias)},
                       None if lora is None else {k: T(v) for k, v in lora.items()}, 2.0)
    want = jlayers.dense(jnp.asarray(x), {"w": jnp.asarray(w), "b": jnp.asarray(bias)},
                         None if lora is None else {k: jnp.asarray(v) for k, v in lora.items()},
                         2.0)
    want = np.asarray(want)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-6 * np.sqrt(48) * np.abs(want).max())


def test_init_layouts_match_reference(pair):
    """Parameter count, LoRA tree layout and prefill cache layout are the
    reference's."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    model = models.init_params(cfg, seed=3, device="cpu")
    n_ref = sum(int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(pair["jp"]))
    assert models.model.param_count(model) == n_ref
    lora = models.init_lora_params(cfg, seed=3, device="cpu")
    jshapes = [tuple(x.shape) for x in jax.tree_util.tree_leaves(jinit_lora(
        jax.random.PRNGKey(0), jcfg))]
    assert [tuple(x.shape) for x in tree_leaves(lora)] == jshapes
    assert all(float(x.abs().max()) == 0 for x in tree_leaves(
        [g["mixer"][t]["B"] for g in lora["groups"] for t in cfg.lora.targets]))
    caches = models.init_decode_caches(cfg, 2, 9, device="cpu")
    k = caches["groups"][0]["self"].k
    assert k.shape == (cfg.n_layers, 2, 9, cfg.n_kv_heads, cfg.head_dim_)
    ext = models.extend_caches(caches, 3, cfg)
    assert ext["groups"][0]["self"].v.shape[-3] == 12


@pytest.mark.parametrize("adapter", ["none", "single"])
def test_prefill_and_decode_match_jax(pair, adapter):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    jl, tl = (None, None) if adapter == "none" else (pair["jl"], pair["tl"])
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    jlog, jc, _ = jforward(pair["jp"], jl, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill",
                           remat=False)
    tlog, tc, _ = models.forward(pair["model"], tl, {"tokens": T(toks).long()}, cfg,
                                 mode="prefill")
    tol = 2e-5 * float(np.abs(np.asarray(jlog)).max())
    assert tlog.shape == (3, 1, cfg.vocab_size) and tlog.dtype == torch.float32
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    jc, tc = jextend(jc, 3, jcfg), models.extend_caches(tc, 3, cfg)
    np.testing.assert_allclose(tc["groups"][0]["self"].k.numpy(),
                               np.asarray(jc["groups"][0]["self"].k), atol=1e-5, rtol=0)
    tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
    for i in range(3):
        jlog, jc = jdecode(pair["jp"], jl, jnp.asarray(tok), jc, jnp.asarray(20 + i), jcfg)
        tlog, tc = models.decode_step(pair["model"], tl, T(tok).long(), tc, 20 + i, cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
        tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)


def test_entry_points_default_to_the_card(monkeypatch):
    """``init_params`` and ``init_lora_params`` run on the card unless the
    CPU is asked for, and raise without CUDA."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config(ARCH).reduced()
    for fn in (models.init_params, models.init_lora_params):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            fn(cfg)


def test_unported_parts_raise(pair):
    """An unknown mode is refused; the GELU MLP, the int8 cache,
    cross-attention and M-RoPE build on this config.  (The one part left
    out, a start state for the SSD kernel on a card, raises there:
    ``ssd_chunked``'s ``h_init``, which no caller passes.)"""
    cfg, model = pair["cfg"], pair["model"]
    toks = {"tokens": torch.zeros((1, 4), dtype=torch.long)}
    with pytest.raises(ValueError, match="mode"):
        models.forward(model, None, toks, cfg, mode="score")
    for change in (dict(ffn_kind="gelu"), dict(kv_quant=True), dict(encoder_decoder=True),
                   dict(mrope=True)):
        changed = cfg.replace(**change)
        assert models.model.param_count(models.init_params(changed, device="cpu")) > 0
        assert models.init_lora_params(changed, device="cpu")["groups"]
    x = torch.zeros((1, 3, 2, 32))
    assert torch.equal(layers.apply_mrope(x, torch.zeros((3, 1, 3)), 1.0, (4, 6, 6)), x)
    assert kvcache.attn_cache(1, 4, 2, 8, torch.float32, quantized=True).k_q.dtype == torch.int8


@pytest.mark.parametrize("window,kv_len", [(0, None), (3, None), (0, 5)])
def test_naive_and_decode_attention_match_jax(window, kv_len):
    """The plain-torch attention paths (outside any kernel in both
    packages) on (B, S, n_kv, G, D) = (2, 7, 2, 2, 16)."""
    from repro.models import attention as jattention

    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 7, 2, 2, 16)).astype(np.float32)
    k, v = (rng.normal(size=(2, 7, 2, 16)).astype(np.float32) for _ in range(2))
    got = attention.naive_attention(T(q), T(k), T(v), causal=True, window=window, kv_len=kv_len)
    want = jattention.naive_attention(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                      causal=True, window=window, kv_len=kv_len)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEM)
    got = attention.decode_attention(T(q[:, :1]), T(k), T(v), 5, window=window)
    want = jattention.decode_attention(jnp.asarray(q[:, :1]), jnp.asarray(k), jnp.asarray(v),
                                       jnp.full((2,), 5), window=window)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **ELEM)
