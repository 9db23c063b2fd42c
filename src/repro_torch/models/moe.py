"""Mixture-of-Experts FFN with capacity-bounded dispatch (port of
``repro/models/moe.py``).

A router (fp32 dense, d_model -> E) picks ``top_k`` experts per token; each
expert holds up to ``capacity`` tokens in an (E, C, D) buffer, and entries
past capacity are dropped (they contribute zero).  The experts are a SwiGLU
each, stacked on a leading expert axis and run as three ``torch.bmm``.  The
reference computes all of this outside any Pallas kernel (``einsum``,
scatter and gather), so this is its port, not a kernel.

Routing, capacity and the Switch-style load-balance loss are computed per
*group*: ``groups`` equal, contiguous blocks of the batch rows, each routed
on its own.  The batched local phase of ``launch/steps.py`` runs every
client's rows as one batch and passes one group a client, as the reference
``vmap``s each client's ``loss_fn``; serving routes its whole batch as one
group.

Each kept (token, k) entry owns one row of its expert's buffer, so the
dispatch is an indexed set and the combine a gather through that one-to-one
map; the dropped entries all use one extra row, which is thrown away.  Their
backward passes are a gather and a set, and a sum over k: no float atomics
reach a kept row, and no ``index_add_``.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch.models import layers

# While ``routing_log`` is active: one (top_e, top_p, probs) per apply_moe call.
_LOG: Optional[list] = None


class MoE(nn.Module):
    """The layer's parameters, named as the reference's pytree node:
    ``router`` ({"w": (d_model, E)}, float32), ``gate`` and ``up``
    (E, d_model, d_ff), ``down`` (E, d_ff, d_model)."""

    def __getitem__(self, key: str):
        return getattr(self, key)


def init_moe(gen, d_model: int, d_ff: int, n_experts: int, *, dtype, device) -> MoE:
    """The reference's initializer on ``gen``: the router as ``init_dense``,
    the experts U(+-1/sqrt(fan-in)); ``gen=None`` leaves them unfilled (the
    converter writes them)."""
    p = MoE()
    p.router = layers.init_dense(gen, d_model, n_experts, dtype=torch.float32, device=device)

    def uniform(shape, fan_in):
        w = torch.empty(shape, dtype=dtype, device=device)
        if gen is not None:
            scale = 1.0 / math.sqrt(fan_in)
            w.uniform_(-scale, scale, generator=gen)
        return layers._param(w)

    p.gate = uniform((n_experts, d_model, d_ff), d_model)
    p.up = uniform((n_experts, d_model, d_ff), d_model)
    p.down = uniform((n_experts, d_ff, d_model), d_ff)
    return p


def _capacity(n_tokens: int, top_k: int, n_experts: int, capacity_factor: float) -> int:
    """ceil(T k cf / E), rounded up to a multiple of 8, at least 8."""
    cap = int(math.ceil(n_tokens * top_k * capacity_factor / n_experts))
    return max(8, -(-cap // 8) * 8)


def route(params, xt: torch.Tensor, top_k: int):
    """Router of (G, T, D) tokens: float32 probabilities (G, T, E), the
    top-k experts (G, T, k) as a stable descending sort (ties to the lower
    index, as ``jax.lax.top_k``) and their weights renormalized over the
    selected experts with a 1e-9 floor."""
    logits = layers.dense(xt.float(), params["router"])
    probs = torch.softmax(logits, dim=-1)
    top_p, top_e = torch.sort(probs, dim=-1, descending=True, stable=True)
    top_p, top_e = top_p[..., :top_k], top_e[..., :top_k]
    top_p = top_p / torch.clamp_min(torch.sum(top_p, dim=-1, keepdim=True), 1e-9)
    return probs, top_e, top_p


def apply_moe(params, x: torch.Tensor, *, top_k: int, capacity_factor: float = 1.25,
              groups: int = 1) -> Tuple[torch.Tensor, torch.Tensor]:
    """x (B, S, D) -> (output (B, S, D), aux (groups,)).

    The B rows form ``groups`` equal, contiguous groups; each is routed on
    its own (``route``), with its own capacity (``_capacity`` of its T =
    B S / groups tokens), positions (a cumsum of the one-hot over its T k
    entries in token-major order) and aux, E sum_e f_e p_e (f_e the share of
    its entries routed to e, p_e its mean probability).  The experts' SwiGLU
    runs in x's dtype; dropped entries contribute zero, the others their
    expert's output times their weight, summed over k."""
    b, s, d = x.shape
    if b % groups:
        raise ValueError(f"batch {b} is not divisible into {groups} groups")
    n_exp = params["gate"].shape[0]
    t = b * s // groups
    xt = x.reshape(groups, t, d)

    probs, top_e, top_p = route(params, xt, top_k)
    if _LOG is not None:
        _LOG.append((top_e.detach(), top_p.detach(), probs.detach()))
    onehot = F.one_hot(top_e.reshape(groups, t * top_k), n_exp)  # (G, T k, E)
    dispatch_frac = onehot.reshape(groups, t, top_k, n_exp).sum(dim=2).float().mean(dim=1)
    aux = n_exp * torch.sum(dispatch_frac * probs.mean(dim=1), dim=-1)

    cap = _capacity(t, top_k, n_exp, capacity_factor)
    flat_e = top_e.reshape(groups, t * top_k)
    # Each entry's place in its expert's queue: the experts' running counts
    # scanned along the entries, read at the entry's expert.  The scan runs
    # with the entries innermost: along the outer axis of the (G, T k, E)
    # one-hot it has only E columns to spread over the card.
    counts = torch.cumsum(onehot.transpose(1, 2), dim=-1)  # (G, E, T k)
    pos = torch.gather(counts, 1, flat_e[:, None]).squeeze(1) - 1  # (G, T k)
    keep = pos < cap
    slot = torch.where(keep, flat_e * cap + pos, n_exp * cap)  # buffer row, or the drop row
    rows = (torch.arange(groups, device=x.device)[:, None], slot)

    entries = xt[:, :, None].expand(groups, t, top_k, d).reshape(groups, t * top_k, d)
    expert_in = xt.new_zeros((groups, n_exp * cap + 1, d)).index_put(rows, entries)
    expert_in = expert_in[:, :-1].reshape(groups, n_exp, cap, d).transpose(0, 1).reshape(
        n_exp, groups * cap, d)
    h = F.silu(torch.bmm(expert_in, params["gate"].to(x.dtype)))
    h = h * torch.bmm(expert_in, params["up"].to(x.dtype))
    expert_out = torch.bmm(h, params["down"].to(x.dtype))  # (E, G C, D)
    flat_out = expert_out.reshape(n_exp, groups, cap, d).transpose(0, 1).reshape(
        groups, n_exp * cap, d)

    per_k = F.pad(flat_out, (0, 0, 0, 1))[rows]  # (G, T k, D), dropped rows zero
    weights = top_p.reshape(groups, t * top_k).to(x.dtype)
    out = (per_k * weights[..., None]).reshape(groups, t, top_k, d).sum(dim=2)
    return out.reshape(b, s, d), aux


@contextlib.contextmanager
def routing_log():
    """Record every ``apply_moe`` call's routing while active: yields a list
    that gains (top_e, top_p, probs) a call, in layer order (card-vs-CPU
    checks compare the experts chosen before they compare outputs)."""
    global _LOG
    prev, _LOG = _LOG, []
    try:
        yield _LOG
    finally:
        _LOG = prev


__all__ = ["MoE", "apply_moe", "init_moe", "route", "routing_log"]
