"""The port's VLM backbone (Qwen2-VL-2B) against the JAX package, on the CPU
at the reduced size in float32: the config and the full model's parameter
count; ``apply_mrope`` at the full sections (16, 24, 24) and the reduced
(4, 6, 6), with distinct position streams and with equal ones (where it is
``apply_rope`` at ``rope_pct = 1``); the vision splice and the positions
of ``_embed_inputs``; train-mode logits with explicit (3, B, S) positions
(a grid for the vision prefix, then text) and without; prefill and decode;
and the federated local step with the stub and the positions on the client
axis.  Weights come across with ``convert.model_from_jax``.

Tolerances: M-RoPE elementwise to atol 2e-6 (cos and sin of float32
angles up to ~1e2 rad, rounded by each library); logits 2e-5 of the
largest (``tests/test_torch_models.py``); embeddings bitwise; local-step
deltas per leaf within 1e-4 of the reference's norm and elementwise within
1e-4 of the largest (``tests/test_torch_train.py``), as are the port's own
microbatched deltas against its whole-batch ones (gradient sums in another
order).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.core import AggregatorConfig as JConfig
from repro.launch import steps as jsteps
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import layers as jlayers
from repro.models import model as jmodel
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.core import AggregatorConfig
from repro_torch.launch import steps
from repro_torch.models import layers
from repro_torch.utils.pytree import tree_leaves

ARCH = "qwen2-vl-2b"
LOGIT_RTOL = 2e-5
ROPE_ATOL = 2e-6
STATE_FRO_RTOL = 1e-4


def T(a):
    return torch.from_numpy(np.array(a))


def grid_positions(b: int, s: int, rows: int, cols: int) -> np.ndarray:
    """(3, B, S) M-RoPE positions of a ``rows x cols`` vision grid followed
    by text: the grid's tokens at temporal 0, height its row, width its
    column; then each text token one past the largest so far on all three
    streams (Qwen2-VL's layout)."""
    pos = np.zeros((3, b, s), np.int64)
    n = rows * cols
    pos[1, :, :n] = np.repeat(np.arange(rows), cols)
    pos[2, :, :n] = np.tile(np.arange(cols), rows)
    pos[:, :, n:] = max(rows, cols) + np.arange(s - n)
    return pos


@pytest.fixture(scope="module")
def pair():
    jcfg, cfg = jconfigs.get_config(ARCH).reduced(), get_config(ARCH).reduced()
    jp = jinit(jax.random.PRNGKey(0), jcfg)
    model = model_from_jax(jax.tree_util.tree_map(np.asarray, jp), cfg)
    rng = np.random.default_rng(1)
    jl = jax.tree_util.tree_map(
        lambda a: jnp.asarray(0.1 * rng.normal(size=a.shape), jnp.float32),
        jinit_lora(jax.random.PRNGKey(1), jcfg))
    toks = rng.integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
    ve = rng.normal(size=(3, cfg.n_vision_tokens, cfg.d_model)).astype(np.float32)
    return dict(jcfg=jcfg, cfg=cfg, jp=jp, model=model, jl=jl,
                tl=from_jax_tree(jax.tree_util.tree_map(np.asarray, jl)),
                toks=toks, ve=ve, pos=grid_positions(3, 20, 2, 4))


def batches(pair, positions: bool):
    jb = {"tokens": jnp.asarray(pair["toks"]), "vision_embeds": jnp.asarray(pair["ve"])}
    tb = {"tokens": T(pair["toks"]).long(), "vision_embeds": T(pair["ve"])}
    if positions:
        jb["positions"] = jnp.asarray(pair["pos"], jnp.int32)
        tb["positions"] = T(pair["pos"])
    return jb, tb


def test_config_matches_reference_and_builds_at_full_width():
    assert dataclasses.asdict(get_config(ARCH)) == dataclasses.asdict(jconfigs.get_config(ARCH))
    assert (dataclasses.asdict(get_config(ARCH).reduced())
            == dataclasses.asdict(jconfigs.get_config(ARCH).reduced()))
    cfg = get_config(ARCH)
    model = models.DecoderLM(cfg, None, device="meta")
    assert not hasattr(model, "lm_head") and not hasattr(model, "encoder")
    want = jax.eval_shape(lambda k: jinit(k, jconfigs.get_config(ARCH)), jax.random.PRNGKey(0))
    assert models.model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


@pytest.mark.parametrize("sections,dh", [((16, 24, 24), 128), ((4, 6, 6), 32)])
@pytest.mark.parametrize("streams", ["distinct", "equal"])
def test_apply_mrope_matches_jax(sections, dh, streams):
    rng = np.random.default_rng(2)
    x = rng.normal(size=(2, 9, 3, dh)).astype(np.float32)
    if streams == "distinct":
        pos = rng.integers(0, 100, size=(3, 2, 9))
    else:
        pos = np.broadcast_to(np.arange(9) + 50, (3, 2, 9)).copy()
    got = layers.apply_mrope(T(x), T(pos), 1e6, sections)
    want = jlayers.apply_mrope(jnp.asarray(x), jnp.asarray(pos, jnp.int32), 1e6, sections)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ROPE_ATOL, rtol=0)
    rope = layers.apply_rope(T(x), T(pos[0]), 1e6, 1.0)
    if streams == "equal":
        # Text tokens: M-RoPE is 1-D RoPE over the full head width.
        torch.testing.assert_close(got, rope, atol=0, rtol=0)
    else:
        assert float((got - rope).abs().max()) > 1e-2
    with pytest.raises(AssertionError):
        layers.apply_mrope(T(x), T(pos), 1e6, (1, 1, 1))


@pytest.mark.parametrize("mode", ["train", "prefill", "decode"])
def test_embed_inputs_match_jax(pair, mode):
    """The vision embeddings replace the first n_vision positions outside
    decode; the positions default to three equal streams (``cache_index``
    when decoding)."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jb, tb = batches(pair, positions=False)
    if mode == "decode":
        jb, tb = {"tokens": jb["tokens"][:, :1]}, {"tokens": tb["tokens"][:, :1]}
    jx, jpos = jmodel._embed_inputs(pair["jp"], jb, jcfg, mode, jnp.asarray(7))
    tx, tpos = models.model._embed_inputs(pair["model"], tb, cfg, mode, 7)
    np.testing.assert_array_equal(tx.numpy(), np.asarray(jx))
    np.testing.assert_array_equal(tpos.numpy(), np.asarray(jpos))
    if mode != "decode":
        np.testing.assert_array_equal(tx[:, :cfg.n_vision_tokens].numpy(), pair["ve"])
        jb2, tb2 = batches(pair, positions=True)
        _, jpos2 = jmodel._embed_inputs(pair["jp"], jb2, jcfg, mode, None)
        _, tpos2 = models.model._embed_inputs(pair["model"], tb2, cfg, mode, None)
        np.testing.assert_array_equal(tpos2.numpy(), np.asarray(jpos2))


@pytest.mark.parametrize("positions", [False, True])
def test_train_forward_matches_jax(pair, positions):
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jb, tb = batches(pair, positions)
    jlog, _, _ = jforward(pair["jp"], pair["jl"], jb, jcfg, mode="train", remat=False)
    tlog, _, _ = models.forward(pair["model"], pair["tl"], tb, cfg, mode="train", remat=True)
    tol = LOGIT_RTOL * float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    if positions:  # the sections move the vision prefix's logits
        plain, _, _ = models.forward(pair["model"], pair["tl"], batches(pair, False)[1], cfg,
                                     mode="train")
        assert float((plain - tlog)[:, :cfg.n_vision_tokens].abs().max()) > 100 * tol


@pytest.mark.parametrize("adapter", ["none", "single"])
def test_prefill_and_decode_match_jax(pair, adapter):
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    jl, tl = (None, None) if adapter == "none" else (pair["jl"], pair["tl"])
    jb, tb = batches(pair, positions=False)
    jlog, jc, _ = jforward(pair["jp"], jl, jb, jcfg, mode="prefill", remat=False)
    tlog, tc, _ = models.forward(pair["model"], tl, tb, cfg, mode="prefill")
    tol = LOGIT_RTOL * float(np.abs(np.asarray(jlog)).max())
    np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
    jc, tc = jextend(jc, 3, jcfg), models.extend_caches(tc, 3, cfg)
    tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)
    for i in range(3):
        jlog, jc = jdecode(pair["jp"], jl, jnp.asarray(tok), jc, jnp.asarray(20 + i), jcfg)
        tlog, tc = models.decode_step(pair["model"], tl, T(tok).long(), tc, 20 + i, cfg)
        np.testing.assert_allclose(tlog.numpy(), np.asarray(jlog), atol=tol, rtol=0)
        tok = np.argmax(np.asarray(jlog)[:, -1:], -1).astype(np.int32)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_local_step_with_stub_and_positions_matches_jax(pair, microbatch):
    """One SGD local phase of 2 clients x 2 sequences with ``vision_embeds``
    (M, per, n_vision, D) and, without microbatches, explicit ``positions``
    (M, 3, per, S) on the client axis, against the reference's vmapped
    ``make_local_step`` (whose microbatch slicing cuts axis 0 of every
    input, which for positions is the stream axis: there the positions stay
    the default)."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    rng = np.random.default_rng(3)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 2, 17))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy(),
             "vision_embeds": rng.normal(size=(2, 2, cfg.n_vision_tokens, cfg.d_model)).astype(
                 np.float32)}
    if microbatch == 1:
        pos = grid_positions(2, 16, 2, 4)  # (3, per, S) for each client
        batch["positions"] = np.stack([pos, pos + 1])
    kw = dict(local_lr=1e-2, local_steps=2, local_optimizer="sgd", remat=False,
              microbatch=microbatch)
    jbatch = {k: jnp.asarray(v, jnp.int32 if k == "positions" else None)
              for k, v in batch.items()}
    jd, jloss_, _ = jax.jit(jsteps.make_local_step(jcfg, **kw))(pair["jp"], pair["jl"], jbatch)
    td, tloss, _ = steps.make_local_step(cfg, **kw)(
        pair["model"], pair["tl"], {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tloss), float(jloss_), rtol=1e-5)
    for g, w in zip(tree_leaves(td), jax.tree_util.tree_leaves(jd)):
        w = np.asarray(w)
        assert np.linalg.norm(g.numpy() - w) <= STATE_FRO_RTOL * np.linalg.norm(w)
        assert np.abs(g.numpy() - w).max() <= 1e-4 * np.abs(w).max()


def test_fed_train_step_with_stub_matches_jax(pair):
    """One FedRPCA round over 2 clients with ``vision_embeds`` on the client
    axis, as ``tests/test_arch_smoke.py::test_fed_train_step`` runs it: the
    loss and the new global LoRA (within 1e-5 of each leaf's largest
    entry, ``tests/test_torch_train.py``), every leaf moved."""
    jcfg, cfg = pair["jcfg"], pair["cfg"]
    rng = np.random.default_rng(5)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 2, 17))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy(),
             "vision_embeds": rng.normal(size=(2, 2, cfg.n_vision_tokens, cfg.d_model)).astype(
                 np.float32)}
    agg = dict(method="fedrpca", rpca_iters=10)
    jnew, jm = jsteps.make_fed_train_step(jcfg, JConfig(**agg), local_lr=1e-3, remat=False)(
        pair["jp"], pair["jl"], {k: jnp.asarray(v) for k, v in batch.items()})
    tnew, tm = steps.make_fed_train_step(cfg, AggregatorConfig(**agg), local_lr=1e-3,
                                         remat=False)(
        pair["model"], pair["tl"], {k: torch.as_tensor(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    for g, w, l0 in zip(tree_leaves(tnew), jax.tree_util.tree_leaves(jnew),
                        tree_leaves(pair["tl"])):
        w = np.asarray(w)
        assert np.abs(w - l0.numpy()).max() > 0
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5 * np.abs(w).max(), rtol=0)


def test_positions_ride_the_client_axis_through_microbatches(pair):
    """With explicit positions, one SGD step over two microbatch slices gives
    the deltas of the whole batch: each slice carries its own rows'
    positions, and with equal token counts the mean of the slices' mean
    losses is the whole batch's."""
    cfg = pair["cfg"]
    rng = np.random.default_rng(4)
    toks = rng.integers(0, cfg.vocab_size, size=(2, 2, 17))
    pos = grid_positions(2, 16, 2, 4)
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy(),
             "vision_embeds": rng.normal(size=(2, 2, cfg.n_vision_tokens, cfg.d_model)).astype(
                 np.float32),
             "positions": np.stack([pos, pos + 3])}
    tb = {k: torch.as_tensor(v) for k, v in batch.items()}
    kw = dict(local_lr=1e-2, local_steps=1, local_optimizer="sgd", remat=False)
    whole, _, _ = steps.make_local_step(cfg, **kw)(pair["model"], pair["tl"], tb)
    sliced, _, _ = steps.make_local_step(cfg, microbatch=2, **kw)(pair["model"], pair["tl"], tb)
    for a, b in zip(tree_leaves(sliced), tree_leaves(whole)):  # sums in another order
        torch.testing.assert_close(a, b, atol=1e-4 * float(b.abs().max()), rtol=0)
