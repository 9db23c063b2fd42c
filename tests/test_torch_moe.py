"""The port's mixture of experts (``models/moe.py``) against the JAX
package, on the CPU in float32: ``apply_moe`` (with drops forced by a small
capacity factor, with a planted probability tie, and routed in groups),
``loss_fn`` with its aux and LoRA gradients, the batched local phase's
per-client losses against the reference's vmapped per-client ``loss_fn``
(with and without microbatches), and prefill and decode logits, for the
reduced ``granite-moe-1b-a400m`` and ``llama4-maverick-400b-a17b``.

Tolerances:
* ``apply_moe``: 1e-5 of the largest output (sums of d_model and d_ff
  products in another order); aux 1e-6 relative (a sum of E products of
  means); the chosen experts equal (they decide the drops, so the outputs
  would differ by whole expert rows otherwise).
* ``loss_fn``: total, ce and aux 1e-5 relative; LoRA gradients 1e-4 of each
  leaf's largest entry (fp32 sums through 2 layers, as
  ``tests/test_torch_train.py``'s ``GRAD_RTOL``).
* Local phase (SGD): deltas 1e-4 of each leaf's largest, losses 1e-5.
* Logits: 2e-5 of the largest logit (``tests/test_torch_models.py``).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.launch import steps as jsteps
from repro.models import decode_step as jdecode
from repro.models import extend_caches as jextend
from repro.models import forward as jforward
from repro.models import init_lora_params as jinit_lora
from repro.models import init_params as jinit
from repro.models import loss_fn as jloss
from repro.models import moe as jmoe
from repro_torch import models
from repro_torch.configs import get_config
from repro_torch.convert import from_jax_tree, model_from_jax
from repro_torch.launch import steps
from repro_torch.launch import train as train_cli
from repro_torch.models import blocks, moe
from repro_torch.utils.pytree import tree_leaves, tree_map

ARCHS = ["granite-moe-1b-a400m", "llama4-maverick-400b-a17b"]
OUT_RTOL = 1e-5
GRAD_RTOL = 1e-4
LOGIT_RTOL = 2e-5

jloss = jax.jit(jloss, static_argnums=3, static_argnames=("remat",))


def T(a):
    return torch.from_numpy(np.array(a))


def close(got, want, rtol, what=""):
    want = np.asarray(want, np.float64)
    err = float(np.abs(np.asarray(got, np.float64) - want).max())
    assert err <= rtol * float(np.abs(want).max()), (what, err, float(np.abs(want).max()))


@pytest.fixture(scope="module", params=ARCHS)
def pair(request):
    """A reduced MoE model in both packages on the same weights, and a LoRA
    tree with nonzero B."""
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


def moe_params(d, f, e, seed, tie=False):
    """One MoE layer's parameters in both packages; with ``tie`` the router's
    last column repeats its first, so those two experts tie on every
    token."""
    jp = jmoe.init_moe(jax.random.PRNGKey(seed), d, f, e)
    jp = jax.tree_util.tree_map(np.asarray, jp)
    if tie:
        w = np.array(jp["router"]["w"])
        w[:, -1] = w[:, 0]
        jp["router"]["w"] = w
    p = moe.init_moe(None, d, f, e, dtype=torch.float32, device="cpu")
    with torch.no_grad():
        p.router["w"].copy_(T(jp["router"]["w"]))
        for k in ("gate", "up", "down"):
            p[k].copy_(T(jp[k]))
    return jp, p


def drops(p, x, top_k, cf, groups=1):
    """The number of (token, k) entries past capacity, counted by a loop
    over the port's routing."""
    b, s, d = x.shape
    _, top_e, _ = moe.route(p, x.reshape(groups, -1, d), top_k)
    cap = moe._capacity(b * s // groups, top_k, p["gate"].shape[0], cf)
    n = 0
    for g in range(groups):
        seen = {}
        for e in top_e[g].reshape(-1).tolist():
            seen[e] = seen.get(e, 0) + 1
            n += seen[e] > cap
    return n


@pytest.mark.parametrize("case", ["default", "drops", "tie", "top1"])
def test_apply_moe_matches_jax(case):
    d, f, e, k, cf = 32, 48, 8, 2, 1.25
    if case == "drops":
        cf = 0.3
    if case == "top1":
        k = 1
    jp, p = moe_params(d, f, e, 3, tie=case == "tie")
    x = np.random.default_rng(4).normal(size=(3, 40, d)).astype(np.float32)
    want, jaux = jmoe.apply_moe(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(x),
                                top_k=k, capacity_factor=cf)
    got, aux = moe.apply_moe(p, T(x), top_k=k, capacity_factor=cf)
    _, top_e, _ = moe.route(p, T(x).reshape(1, -1, d), k)
    probs = jax.nn.softmax(jnp.asarray(x).reshape(-1, d) @ jnp.asarray(jp["router"]["w"]), -1)
    assert np.array_equal(top_e[0].numpy(), np.asarray(jax.lax.top_k(probs, k)[1]))
    close(got.numpy(), want, OUT_RTOL, "output")
    assert aux.shape == (1,)
    np.testing.assert_allclose(float(aux[0]), float(jaux), rtol=1e-6)
    n_drop = drops(p, T(x), k, cf)
    if case == "drops":
        assert n_drop > 0
    if case == "tie":  # the tied pair: the lower index goes first, as jax.lax.top_k
        te = top_e[0]
        assert bool((te == 0).any())
        for row in te.tolist():
            assert e - 1 not in row or (0 in row and row.index(0) < row.index(e - 1))


def test_apply_moe_groups_route_each_group_alone():
    """``groups=3``: each group's output and aux as the reference's call on
    that group's rows alone (its own capacity and drops)."""
    d, f, e, k, cf = 32, 48, 8, 2, 0.5
    jp, p = moe_params(d, f, e, 5)
    x = np.random.default_rng(6).normal(size=(6, 20, d)).astype(np.float32)
    got, aux = moe.apply_moe(p, T(x), top_k=k, capacity_factor=cf, groups=3)
    assert aux.shape == (3,) and drops(p, T(x), k, cf, groups=3) > 0
    for g in range(3):
        rows = x[2 * g:2 * g + 2]
        want, jaux = jmoe.apply_moe(jax.tree_util.tree_map(jnp.asarray, jp), jnp.asarray(rows),
                                    top_k=k, capacity_factor=cf)
        close(got[2 * g:2 * g + 2].numpy(), want, OUT_RTOL, f"group {g}")
        np.testing.assert_allclose(float(aux[g]), float(jaux), rtol=1e-6)


def test_apply_moe_gradient_is_plain_autograd():
    """The dispatch (an indexed set) and the combine (a gather) differentiate
    through plain autograd: x's gradient equals that of a loop over the
    experts with the same routing, each expert's kept entries (its first
    ``capacity`` in token-major order) through its own SwiGLU (1e-6: the
    same products summed in another order), and two backward passes agree
    bit for bit."""
    d, f, e, k, cf = 16, 24, 4, 2, 0.6
    _, p = moe_params(d, f, e, 7)
    x = torch.randn((2, 10, d), generator=torch.Generator().manual_seed(8))
    g = torch.randn((2, 10, d), generator=torch.Generator().manual_seed(9))

    def loop(live):
        xt = live.reshape(-1, d)
        probs, top_e, top_p = moe.route(p, xt[None], k)
        flat_e, flat_p = top_e.reshape(-1), top_p.reshape(-1)
        cap = moe._capacity(xt.shape[0], k, e, cf)
        out = torch.zeros_like(xt)
        for ex in range(e):
            kept = torch.nonzero(flat_e == ex).flatten()[:cap]
            tok = kept // k
            y = (torch.nn.functional.silu(xt[tok] @ p["gate"][ex]) * (xt[tok] @ p["up"][ex])
                 ) @ p["down"][ex]
            out = out.index_add(0, tok, y * flat_p[kept, None])
        frac = torch.nn.functional.one_hot(flat_e, e).float().sum(0) / xt.shape[0]
        return out.reshape(live.shape), e * torch.sum(frac * probs[0].mean(0))

    def grad_of_x(fn):
        live = x.clone().requires_grad_()
        out, aux = fn(live)
        return out, torch.autograd.grad((out * g).sum() + aux.sum(), live)[0]

    out, got = grad_of_x(lambda v: moe.apply_moe(p, v, top_k=k, capacity_factor=cf))
    out2, again = grad_of_x(lambda v: moe.apply_moe(p, v, top_k=k, capacity_factor=cf))
    assert torch.equal(out, out2) and torch.equal(got, again)
    want_out, want = grad_of_x(loop)
    assert moe._capacity(20, k, e, cf) < 20 * k / e  # some entries are dropped
    torch.testing.assert_close(out, want_out, atol=1e-6, rtol=1e-6)
    torch.testing.assert_close(got, want, atol=1e-6, rtol=1e-6)


def test_routing_log_records_each_layer(pair):
    cfg = pair["cfg"]
    toks = torch.as_tensor(np.random.default_rng(3).integers(0, cfg.vocab_size, size=(2, 9)))
    with moe.routing_log() as log:
        models.forward(pair["model"], None, {"tokens": toks}, cfg, mode="prefill")
    assert len(log) == cfg.n_layers
    assert log[0][0].shape == (1, 18, cfg.top_k)


def test_loss_and_lora_grads_match_jax(pair):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    toks = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(3, 33))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:].copy()}
    batch["labels"][0, :5] = -1
    (jtot, jaux), jg = jax.value_and_grad(
        lambda l: jloss(pair["jp"], l, {k: jnp.asarray(v) for k, v in batch.items()}, jcfg,
                        remat=False), has_aux=True)(pair["jl"])
    live = tree_map(lambda t: t.clone().requires_grad_(), pair["tl"])
    tot, aux = models.loss_fn(pair["model"], live, {k: T(v) for k, v in batch.items()}, cfg)
    grads = torch.autograd.grad(tot, tree_leaves(live))
    assert float(aux["aux"].detach()) > 0
    for got, want in ((tot, jtot), (aux["ce"], jaux["ce"]), (aux["aux"], jaux["aux"])):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    for g, w in zip(grads, jax.tree_util.tree_leaves(jg)):
        close(g.numpy(), w, GRAD_RTOL, "LoRA gradient")


def test_remat_gives_the_same_gradients_and_aux(pair):
    cfg = pair["cfg"]
    toks = np.random.default_rng(4).integers(0, cfg.vocab_size, size=(2, 17))
    batch = {"tokens": T(toks[:, :-1]), "labels": T(toks[:, 1:])}
    out = []
    for remat in (False, True):
        live = tree_map(lambda t: t.clone().requires_grad_(), pair["tl"])
        tot, aux = models.loss_fn(pair["model"], live, batch, cfg, remat=remat)
        out.append((float(aux["aux"]), torch.autograd.grad(tot, tree_leaves(live))))
    assert out[0][0] == out[1][0]
    for a, b in zip(out[0][1], out[1][1]):
        torch.testing.assert_close(a, b, atol=1e-7, rtol=1e-6)


def test_client_losses_match_the_vmapped_reference(pair):
    """``client_losses`` over 3 clients' rows as one batch: each client's
    total (ce and its own aux, its own capacity) as the reference's
    ``loss_fn`` vmapped over the clients."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    toks = np.random.default_rng(5).integers(0, cfg.vocab_size, size=(3, 2, 17))
    tokens, labels = toks[..., :-1], toks[..., 1:].copy()
    want = jax.vmap(lambda t, y: jloss(pair["jp"], pair["jl"], {"tokens": t, "labels": y}, jcfg,
                                       remat=False)[0])(jnp.asarray(tokens), jnp.asarray(labels))
    with torch.no_grad():
        got = models.client_losses(pair["model"], pair["tl"],
                                   {"tokens": T(tokens.reshape(6, -1)),
                                    "labels": T(labels.reshape(6, -1))}, cfg, 3)
        whole = models.loss_fn(pair["model"], pair["tl"],
                               {"tokens": T(tokens.reshape(6, -1)),
                                "labels": T(labels.reshape(6, -1))}, cfg)[1]["aux"]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5)
    # Routed as one batch, the aux would be the whole batch's for everyone.
    per_aux = got.numpy() - np.array([float(jloss(pair["jp"], pair["jl"], {
        "tokens": jnp.asarray(tokens[c]), "labels": jnp.asarray(labels[c])}, jcfg,
        remat=False)[1]["ce"]) for c in range(3)])
    assert not np.allclose(per_aux, cfg.router_aux_weight * float(whole), rtol=1e-5, atol=0)


@pytest.mark.parametrize("microbatch", [1, 2])
def test_local_step_matches_jax(pair, microbatch):
    """One SGD local phase of 3 clients x 4 x 12 tokens, 2 steps (each
    microbatch slice routed per client, as the reference's scan over
    slices inside its vmap)."""
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    toks = np.random.default_rng(6).integers(0, cfg.vocab_size, size=(3, 4, 13))
    batch = {"tokens": toks[..., :-1], "labels": toks[..., 1:].copy()}
    kw = dict(local_lr=1e-1, local_steps=2, local_optimizer="sgd", remat=False,
              microbatch=microbatch)
    jd, jl_, _ = jax.jit(jsteps.make_local_step(jcfg, **kw))(
        pair["jp"], pair["jl"], {k: jnp.asarray(v) for k, v in batch.items()})
    td, tl_, _ = steps.make_local_step(cfg, **kw)(
        pair["model"], pair["tl"], {k: T(v) for k, v in batch.items()})
    np.testing.assert_allclose(float(tl_), float(jl_), rtol=1e-5)
    for g, w in zip(tree_leaves(td), jax.tree_util.tree_leaves(jd)):
        close(g.numpy(), w, 1e-4, "delta")


@pytest.mark.parametrize("adapter", ["none", "single"])
def test_prefill_and_decode_match_jax(pair, adapter):
    cfg, jcfg = pair["cfg"], pair["jcfg"]
    jl, tl = (None, None) if adapter == "none" else (pair["jl"], pair["tl"])
    toks = np.random.default_rng(7).integers(0, cfg.vocab_size, size=(3, 20)).astype(np.int32)
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


@pytest.mark.parametrize("arch", ARCHS)
def test_config_matches_reference_and_builds_at_full_width(arch):
    """Field for field, reduced too; the full model built unfilled on the
    meta device has the reference's parameter count, with ``moe`` in place
    of ``ffn`` in every block."""
    assert dataclasses.asdict(get_config(arch)) == dataclasses.asdict(jconfigs.get_config(arch))
    assert (dataclasses.asdict(get_config(arch).reduced())
            == dataclasses.asdict(jconfigs.get_config(arch).reduced()))
    cfg = get_config(arch)
    model = models.DecoderLM(cfg, None, device="meta")
    assert all(hasattr(b, "moe") and not hasattr(b, "ffn") for b in model.layers)
    want = jax.eval_shape(lambda k: jinit(k, jconfigs.get_config(arch)), jax.random.PRNGKey(0))
    assert models.model.param_count(model) == sum(
        int(np.prod(x.shape)) for x in jax.tree_util.tree_leaves(want))


def test_train_cli_runs_granite_on_the_cpu():
    out = train_cli.main(["--arch", "granite-moe-1b-a400m", "--reduced", "--device", "cpu",
                          "--rounds", "2", "--clients", "3", "--per-client-batch", "2",
                          "--seq", "16"])
    assert len(out["rounds"]) == 2
    assert all(bool(torch.isfinite(x).all()) for x in tree_leaves(out["lora"]))
