"""The port's dense configs of slice 11 against the JAX package, on the CPU:
``gemma-7b`` (MHA at head width 256, GeGLU, ``embed_scale``),
``qwen1.5-32b`` (MHA, ``qkv_bias``) and ``deepseek-67b`` (GQA kv = 8, the
untied output head): each config field for field, reduced too; the full
model's parameter count built unfilled on the meta device; and prefill and
decode logits of the reduced model on the reference's weights
(``convert.model_from_jax``, which carries deepseek's ``lm_head`` across),
float32.

Tolerance: logits 2e-5 of the largest logit (2 layers of sums of up to 512
products, softmax and norms in another order; ``tests/test_torch_models.py``).
"""
import dataclasses

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
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.launch import serve

ARCHS = ["gemma-7b", "qwen1.5-32b", "deepseek-67b"]
LOGIT_RTOL = 2e-5


def T(a):
    return torch.from_numpy(np.array(a))


def test_only_whisper_and_qwen2_vl_stay_unported():
    """Whisper-medium and Qwen2-VL-2B: each equal to the reference's
    (reduced too) and built at full width with the reference's parameter
    count (``tests/test_torch_encdec.py``, ``tests/test_torch_vlm.py``
    hold their numbers)."""
    for arch in ("whisper-medium", "qwen2-vl-2b"):
        assert (dataclasses.asdict(get_config(arch))
                == dataclasses.asdict(jconfigs.get_config(arch)))
        assert (dataclasses.asdict(get_config(arch).reduced())
                == dataclasses.asdict(jconfigs.get_config(arch).reduced()))
        model = models.DecoderLM(get_config(arch), None, device="meta")
        want = jax.eval_shape(lambda k, a=arch: jinit(k, jconfigs.get_config(a)),
                              jax.random.PRNGKey(0))
        assert models.model.param_count(model) == sum(
            int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_and_builds_at_full_width(arch):
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jconfigs.get_config(arch))
    assert (dataclasses.asdict(get_config(arch).reduced())
            == dataclasses.asdict(jconfigs.get_config(arch).reduced()))
    cfg = get_config(arch)
    model = models.DecoderLM(cfg, None, device="meta")
    assert hasattr(model, "lm_head") == (not cfg.tie_embeddings)
    want = jax.eval_shape(lambda k: jinit(k, jconfigs.get_config(arch)), jax.random.PRNGKey(0))
    assert models.model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
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


def test_untied_head_is_carried_across(pair):
    if pair["cfg"].tie_embeddings:
        assert not hasattr(pair["model"], "lm_head") and "lm_head" not in pair["jp"]
    else:
        assert torch.equal(pair["model"].lm_head, T(pair["jp"]["lm_head"]))
        assert not torch.equal(pair["model"].lm_head, pair["model"].embed.T)


@pytest.mark.parametrize("adapter", ["none", "single"])
def test_prefill_and_decode_match_jax(pair, adapter):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    jl, tl = (None, None) if adapter == "none" else (pair["jl"], pair["tl"])
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    jlog, jc, _ = jforward(pair["jp"], jl, {"tokens": jnp.asarray(toks)}, jcfg, mode="prefill",
                           remat=False)
    tlog, tc, _ = models.forward(pair["model"], tl, {"tokens": T(toks).long()}, cfg,
                                 mode="prefill")
    tol = LOGIT_RTOL * float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    jc, tc = jextend(jc, 3, jcfg), models.extend_caches(tc, 3, cfg)
    tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
    for i in range(3):
        jlog, jc = jdecode(pair["jp"], jl, jnp.asarray(tok), jc, jnp.asarray(20 + i), jcfg)
        tlog, tc = models.decode_step(pair["model"], tl, T(tok).long(), tc, 20 + i, cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
        tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)


@pytest.mark.parametrize("arch", ["deepseek-67b", "granite-moe-1b-a400m"])
def test_serve_cli_runs_on_the_cpu(arch):
    out = serve.main(["--arch", arch, "--reduced", "--device", "cpu", "--batch", "4",
                      "--prompt-len", "16", "--gen", "4", "--n-adapters", "2",
                      "--pool-slots", "4"])
    assert out.shape == (4, 4)
