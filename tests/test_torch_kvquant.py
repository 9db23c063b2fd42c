"""The port's int8 KV cache (``kv_quant``) against the JAX package, on the
CPU in float32: ``quantize_kv`` bit for bit (round half to even, the scale
rounded to float16 before the division), the roundtrip error, prefill
caches and decode with an int8 cache against the reference's int8 decode
for a full-attention config (reduced StableLM-2-1.6B) and a windowed one
whose ring wraps (reduced RecurrentGemma-2B, prompt 40 past the window of
32), ``extend_caches`` and ``init_decode_caches`` on quantized caches, and
the cache's bytes against a bf16 cache.

Tolerances: ``quantize_kv`` bitwise; the roundtrip within half a float16
scale step plus the scale's own rounding (2^-11 of |x|); the model's int8
caches equal except where the two packages' float32 K and V sit within
rounding of a half step (at most 1e-3 of the entries, each one step off);
decode logits from the reference's own cache bits 2e-5 of the largest
(``tests/test_torch_models.py``), and on the port's own caches the greedy
tokens equal.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import kvcache as jkv
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.models import kvcache
from repro_torch.models.kvcache import KVCache, QuantKVCache

LOGIT_RTOL = 2e-5
FLIP_SHARE = 1e-3


def T(a):
    return torch.from_numpy(np.array(a))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_kv_bits_equal_the_reference(dtype):
    rng = np.random.default_rng(0)
    x = (rng.normal(size=(2, 33, 3, 64)) * rng.uniform(1e-3, 30, size=(2, 33, 3, 1)))
    # Exact halves: a row of largest magnitude 63.5 has scale 0.5 in float16,
    # so 0.25, 0.75 and 1.25 sit at 0.5, 1.5 and 2.5 steps (to even: 0, 2, 2).
    x[0, 0, 0, :4] = [63.5, 0.25, 0.75, -1.25]
    x[0, 0, 0, 4:] = 0.0
    x[1, 2, 1] = 0.0  # an all-zero row: scale 0, values 0
    jx = jnp.asarray(x, dtype)
    tx = torch.from_numpy(x.astype(np.float32)).to(getattr(torch, dtype))
    jq, js = jkv.quantize_kv(jx)
    tq, ts = kvcache.quantize_kv(tx)
    assert tq.dtype == torch.int8 and ts.dtype == torch.float16
    assert tuple(ts.shape) == (2, 33, 3, 1)
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert tq[0, 0, 0, :4].tolist() == [127, 0, 2, -2]
    want = jkv.dequantize_kv(jq, js, jnp.float32)
    got = kvcache.dequantize_kv(tq, ts, torch.float32)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_roundtrip_error_is_half_a_step():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.normal(size=(4, 50, 2, 128)).astype(np.float32) * 3)
    q, s = kvcache.quantize_kv(x)
    back = kvcache.dequantize_kv(q, s, torch.float32)
    step = s.float()
    bound = 0.5 * step + 2.0**-11 * x.abs() + 1e-7
    assert bool(((back - x).abs() <= bound).all())
    assert int(q.abs().max()) == 127


def pair_for(arch):
    jcfg = jconfigs.get_config(arch).reduced().replace(kv_quant=True)
    cfg = get_config(arch).reduced().replace(kv_quant=True)
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(2)
    jl = jax.tree_util.tree_map(lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape),
                                                      jnp.float32),
                                jinit_lora(jax.random.PRNGKey(1), jcfg))
    return jcfg, cfg, jp, model, jl, from_jax_tree(jax.tree_util.tree_map(np.asarray, jl))


def quant_nodes(caches):
    return [c["self"] for c in (*caches["groups"], *caches["tail"])
            if isinstance(c["self"], (QuantKVCache, jkv.QuantKVCache))]


def port_caches(jc):
    """The reference's cache tree as the port's: the same bits in the port's
    containers (``QuantKVCache``, ``KVCache``, ``LRUState`` by name)."""
    def node(state):
        return getattr(kvcache, type(state).__name__)(*(T(t) for t in state))

    return {part: tuple({k: node(v) for k, v in c.items()} for c in jc[part])
            for part in ("groups", "tail")}


def assert_int8_close(got, want):
    """Equal int8 values but for rare one-step flips; equal or one-ulp
    float16 scales."""
    for t, j in zip(quant_nodes(got), quant_nodes(want)):
        for a, b in zip(t, j):
            a, b = a.numpy(), np.asarray(b)
            assert a.dtype == b.dtype and a.shape == b.shape
            if a.dtype == np.int8:
                diff = np.abs(a.astype(np.int32) - b.astype(np.int32))
                assert diff.max() <= 1 and (diff > 0).mean() <= FLIP_SHARE
            else:
                np.testing.assert_allclose(a.astype(np.float32), b.astype(np.float32),
                                           rtol=2.0**-10, atol=0)


@pytest.mark.parametrize("arch,prompt", [("stablelm-1.6b", 20), ("recurrentgemma-2b", 40)])
def test_int8_decode_matches_the_reference(arch, prompt):
    """Prefill (int8 caches; RecurrentGemma's rings wrap past the window of
    32), then 4 decode steps against the reference's int8 decode.  Each step
    also runs from the reference's own cache bits, where the logits hold to
    the float32 bound (a one-step flip of one cached value moves them by
    more than that: reduced StableLM's prefill flips one of 15360 values);
    on the port's own caches the greedy tokens are the reference's."""
    jcfg, cfg, jp, model, jl, tl = pair_for(arch)
    toks = np.random.default_rng(3).integers(0, cfg.vocab_size, size=(3, prompt)).astype(
        np.int32)
    jlog, jc, _ = jforward(jp, jl, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill",
                           remat=False)
    tlog, tc, _ = models.forward(model, tl, {"tokens": T(toks).long()}, cfg, mode="prefill")
    assert quant_nodes(tc) and all(isinstance(n, QuantKVCache) for n in quant_nodes(tc))
    assert_int8_close(tc, jc)
    tol = LOGIT_RTOL * float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    jc, tc = jextend(jc, 4, jcfg), models.extend_caches(tc, 4, cfg)
    tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
    for i in range(4):
        from_ref = port_caches(jc)
        jlog, jc = jdecode(jp, jl, jnp.asarray(tok), jc, jnp.asarray(prompt + i), jcfg)
        slog, from_ref = models.decode_step(model, tl, T(tok).long(), from_ref, prompt + i, cfg)
        np.testing.assert_allclose(slog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
        assert_int8_close(from_ref, jc)
        tlog, tc = models.decode_step(model, tl, T(tok).long(), tc, prompt + i, cfg)
        assert_int8_close(tc, jc)
        tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
        assert np.array_equal(torch.argmax(tlog[:, -1:], -1).numpy(), tok)


def test_int8_decode_stays_near_the_bf16_cache_decode():
    """The same weights with and without ``kv_quant`` (both in float32): the
    int8 cache moves the logits by far less than they span."""
    cfg = get_config("stablelm-1.6b").reduced()
    model = models.init_params(cfg, seed=0, device="cpu")
    toks = torch.randint(0, cfg.vocab_size, (2, 24), generator=torch.Generator().manual_seed(4))
    out = {}
    for quant in (False, True):
        c = cfg.replace(kv_quant=quant)
        logits, caches, _ = models.forward(model, None, {"tokens": toks}, c, mode="prefill")
        caches = models.extend_caches(caches, 2, c)
        out[quant] = models.decode_step(model, None, torch.argmax(logits[:, -1:], -1), caches,
                                        24, c)[0]
    spread = float(out[False].max() - out[False].min())
    assert 0 < float((out[True] - out[False]).abs().max()) <= 0.05 * spread


def test_extend_and_init_quantized_caches():
    """``extend_caches`` pads all four tensors of a full-attention int8 cache
    and grows an int8 ring shorter than the window to min(window, length +
    extra); ``init_decode_caches`` gives int8 values and float16 scales."""
    for arch, prompt, want_len in (("stablelm-1.6b", 10, 15), ("recurrentgemma-2b", 20, 25),
                                   ("recurrentgemma-2b", 30, 32)):
        cfg = get_config(arch).reduced().replace(kv_quant=True)
        model = models.init_params(cfg, seed=0, device="cpu")
        toks = torch.zeros((2, prompt), dtype=torch.long)
        _, caches, _ = models.forward(model, None, {"tokens": toks}, cfg, mode="prefill")
        grown = models.extend_caches(caches, 5, cfg)
        for before, after in zip(quant_nodes(caches), quant_nodes(grown)):
            assert isinstance(after, QuantKVCache)
            for a, b in zip(before, after):
                assert b.dtype == a.dtype and b.shape[-3] == want_len
                assert torch.equal(b[..., :prompt, :, :], a)
                assert not b[..., prompt:, :, :].any()
        fresh = models.init_decode_caches(cfg, 2, 40, device="cpu")
        node = quant_nodes(fresh)[0]
        assert (node.k_q.dtype, node.k_scale.dtype) == (torch.int8, torch.float16)
        assert node.k_scale.shape[-1] == 1


@pytest.mark.parametrize("head_dim,ratio", [(64, 0.515625), (128, 0.5078125)])
def test_int8_cache_bytes_against_bf16(head_dim, ratio):
    def nbytes(c):
        return sum(t.numel() * t.element_size() for t in c)

    q = kvcache.attn_cache(8, 100, 2, head_dim, torch.bfloat16, quantized=True)
    b = kvcache.attn_cache(8, 100, 2, head_dim, torch.bfloat16)
    assert isinstance(b, KVCache) and nbytes(q) / nbytes(b) == ratio
