"""Step functions of the LM training CLI (port of ``repro/launch/steps.py``).

A federated round is two independently dispatchable halves:
``make_local_step`` (every client's local LoRA optimization, emitting the
stacked deltas) and ``make_agg_step`` (the server aggregation, threading
the cross-round ``AggCarry``, returning the scaled update).
``make_fed_train_step`` composes them; ``launch/train.py`` drives them
separately through ``fed.pipeline.run_rounds`` so an aggregation can run
behind the next local phase.

The reference vmaps one client's optimization over the clients.  Here the
clients run as one batch: the rows are (clients x per-client sequences),
each tagged with its client's slot, so every LoRA projection is one
gathered kernel call over the client-stacked adapters
(``serve.pool.adapter_view``).  The loss is the sum of the per-client mean
losses (``models.client_losses``): client c's adapter enters only client
c's rows, so its gradient is exactly its own.  One optimizer state is
stacked over the clients (every update is elementwise).
"""
from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from repro_torch.core import AggregatorConfig, aggregate
from repro_torch.core import engine as engine_lib
from repro_torch.core.aggregators import CARRY_MODES, rpca_diag_summary
from repro_torch.models import model as model_lib
from repro_torch.optim import adam, sgd
from repro_torch.optim.optimizers import apply_updates
from repro_torch.serve.pool import adapter_view
from repro_torch.utils import trace
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_unflatten

Tree = Any

#: Salt of the cohort draw (the reference folds 0x5EED into its key).
COHORT_SALT = 0x5EED

#: Frontend inputs that ride along the client axis beside tokens and labels:
#: ``vision_embeds`` (M, per_client, n_vision, D), ``encoder_frames``
#: (M, per_client, S_enc, D) and M-RoPE ``positions`` (M, 3, per_client, S),
#: each client's slice being what the reference's vmapped client sees.
_EXTRA_KEYS = ("vision_embeds", "encoder_frames", "positions")


def _client_rows(key: str, x: torch.Tensor, sl: slice) -> torch.Tensor:
    """The rows ``sl`` of every client's batch as one batch: (n * width, ...)
    for tokens, labels and the stubs, (3, n * width, S) for positions."""
    if key == "positions":
        part = x[:, :, sl]
        return part.transpose(0, 1).reshape(3, -1, part.shape[-1])
    part = x[:, sl]
    return part.reshape(-1, *part.shape[2:])


def cohort_mask(agg_key, n_slots: int, clients_per_round: int) -> torch.Tensor:
    """The (n_slots,) float32 CPU validity mask of a partial-participation
    round: ``clients_per_round`` slots of a random permutation drawn from a
    CPU generator seeded from ``(*agg_key, COHORT_SALT)``, so every device
    draws the same cohort from one key."""
    entropy = [int(v) for v in np.asarray(agg_key, dtype=np.int64).reshape(-1)]
    seed = np.random.SeedSequence([*entropy, COHORT_SALT]).generate_state(1)[0]
    perm = torch.randperm(n_slots, generator=torch.Generator().manual_seed(int(seed)))
    mask = torch.zeros((n_slots,), dtype=torch.float32)
    mask[perm[:clients_per_round]] = 1.0
    return mask


def make_local_step(
    cfg,
    *,
    local_lr: float = 1e-4,
    local_steps: int = 1,
    local_optimizer: str = "sgd",
    remat: bool = True,
    microbatch: int = 1,
    clients_per_round: int = 0,
) -> Callable:
    """Client half of the federated step.

    ``(model, lora_global, batch, agg_key=None, mask=None) -> (deltas,
    loss, mask)``: ``batch`` holds ``tokens`` and ``labels`` of shape
    (M, per_client, S) on the model's device, and the config's frontend
    inputs when it has any (``_EXTRA_KEYS``).  Every client starts from
    ``lora_global`` and takes ``local_steps`` steps of SGD or Adam
    (``local_optimizer``); ``deltas`` are the stacked (M, ...) differences,
    ``loss`` the (masked) mean over clients of each client's last-step loss.

    ``clients_per_round`` > 0 samples a validity mask over the M slots from
    ``agg_key`` (``cohort_mask``; required then), or takes ``mask`` as
    given (a parity test passes the reference's).  Only the active clients
    run; masked slots return exact zero deltas and loss 0, and the mask is
    returned (None under full participation).

    ``microbatch`` > 1 splits each client's batch into that many slices and
    accumulates the gradients over them (the mean of the slices' losses and
    gradients).  ``remat`` recomputes each block in the backward pass.
    """
    if local_optimizer not in ("sgd", "adam"):
        raise ValueError(f"unknown local optimizer {local_optimizer!r}")

    def per_client_loss(model, params, rows_batch, n):
        rows = rows_batch["tokens"].shape[0]
        slots = torch.arange(n, dtype=torch.int32,
                             device=rows_batch["tokens"].device).repeat_interleave(rows // n)
        view = adapter_view(params, slots)
        return model_lib.client_losses(model, view, rows_batch, cfg, n, remat=remat)

    def loss_and_grads(model, params, batch):
        """Per-client losses (n,) and the gradients of their sum, averaged
        over the microbatch slices."""
        n, per = batch["tokens"].shape[0], batch["tokens"].shape[1]
        if per % microbatch:
            raise ValueError(f"per-client batch {per} is not divisible by microbatch "
                             f"{microbatch}")
        leaves = [p.detach().requires_grad_() for p in tree_leaves(params)]
        live = tree_unflatten(params, leaves)
        width = per // microbatch
        loss, grads = 0.0, None
        for i in range(microbatch):
            sl = slice(i * width, (i + 1) * width)
            li = per_client_loss(model, live, {k: _client_rows(k, x, sl)
                                               for k, x in batch.items()}, n)
            gi = torch.autograd.grad(li.sum(), leaves)
            loss = loss + li.detach()
            grads = list(gi) if grads is None else [a + b for a, b in zip(grads, gi)]
        if microbatch > 1:
            loss = loss / microbatch
            grads = [g / microbatch for g in grads]
        return loss, tree_unflatten(params, grads)

    def local_step(model, lora_global, batch, agg_key=None, mask=None):
        batch = {k: batch[k] for k in ("tokens", "labels", *_EXTRA_KEYS) if k in batch}
        m = batch["tokens"].shape[0]
        if clients_per_round > m:
            raise ValueError(f"clients_per_round={clients_per_round} exceeds the batch's "
                             f"{m} client slots")
        if mask is None and clients_per_round and clients_per_round < m:
            if agg_key is None:
                raise ValueError("clients_per_round > 0 requires an agg_key per round")
            mask = cohort_mask(agg_key, m, clients_per_round)
        if isinstance(mask, torch.Tensor):
            trace.sync("cohort", mask.device)  # the mask's copy to the host
        mask_cpu = None if mask is None else torch.as_tensor(mask, dtype=torch.float32).cpu()
        dev = batch["tokens"].device
        if mask_cpu is None:
            act = None
        else:
            act = trace.to_device(torch.nonzero(mask_cpu > 0).flatten(), "cohort", dev)
            batch = {k: x.index_select(0, act) for k, x in batch.items()}
        n = batch["tokens"].shape[0]
        start = tree_map(lambda x: x.detach().unsqueeze(0).expand(n, *x.shape).clone(),
                         lora_global)
        opt = adam(local_lr) if local_optimizer == "adam" else sgd(local_lr)
        params, state = start, opt.init(start)
        loss = None
        for _ in range(local_steps):
            loss, grads = loss_and_grads(model, params, batch)
            upd, state = opt.update(grads, state, params)
            params = apply_updates(params, upd)
        deltas = tree_map(lambda a, b: (a - b).detach(), params, start)
        if act is None:
            return deltas, torch.mean(loss), None
        full = tree_map(lambda d: d.new_zeros((m, *d.shape[1:])).index_copy_(0, act, d), deltas)
        mask_dev = trace.to_device(mask_cpu, "cohort", dev)
        losses = torch.zeros((m,), dtype=loss.dtype, device=dev).index_copy_(0, act, loss)
        loss_mean = torch.sum(mask_dev * losses) / torch.clamp_min(torch.sum(mask_dev), 1.0)
        return full, loss_mean, mask_dev

    return local_step


def apply_update(lora_global: Tree, scaled_update: Tree) -> Tree:
    """Land-time composition: fold an already-scaled update into the global
    (multiplying by exactly 1.0 upstream keeps the synchronous schedule the
    plain ``lora + update``)."""
    return tree_map(lambda g, su: g + su, lora_global, scaled_update)


def make_agg_step(
    agg_cfg: Optional[AggregatorConfig] = None,
    *,
    engine: str = "packed",
    client_weights=None,
    mesh=None,
    uplink=None,
) -> Callable:
    """Server half of the federated step.

    ``(deltas, mask=None, agg_key=None[, agg_carry], scale=1.0) ->
    (scaled_update, metrics[, new_carry])``, on the deltas' device.  With
    ``agg_cfg.carry_mode != "none"`` (packed engine, fedrpca) the step is a
    cross-round session: it plans on its first call, threads ``agg_carry``
    (an empty carry cold-starts) and its metrics carry the session
    scalars, and ``uplink`` ("sketch[:k[:tol]]" or a
    ``fed.sketch.UplinkConfig``) turns on the sketch codec with its byte
    counters.  Otherwise it returns ``(scaled_update, {})``.
    ``client_weights`` are per-client data sizes, used when
    ``agg_cfg.weighting`` is data-size based.  ``mesh`` shards the packed
    client axis (a reference-engine call with a multi-shard mesh raises).
    """
    agg_cfg = agg_cfg or AggregatorConfig()
    if agg_cfg.carry_mode not in CARRY_MODES:
        raise ValueError(
            f"unknown carry_mode: {agg_cfg.carry_mode!r} (expected one of {CARRY_MODES})"
        )
    carry_on = (agg_cfg.carry_mode != "none" and engine == "packed"
                and agg_cfg.method == "fedrpca")
    use_weights = agg_cfg.weighting in ("data_size", "data_size_rpca")
    if use_weights and client_weights is None:
        raise ValueError(
            f"weighting={agg_cfg.weighting!r} requires client_weights; "
            "refusing to silently fall back to uniform"
        )
    plans: dict = {}

    def agg_step(deltas, mask=None, agg_key=None, agg_carry=None, scale=1.0):
        dev = tree_leaves(deltas)[0].device
        weights = None
        if use_weights:
            weights = trace.to_device(np.asarray(client_weights), "cohort", dev, torch.float32)
        if carry_on:
            if "plan" not in plans:
                plans["plan"] = engine_lib.plan_aggregation(deltas, agg_cfg, mesh=mesh,
                                                            uplink=uplink)
            update, new_carry, ediag = engine_lib.aggregate_planned(
                plans["plan"], deltas, agg_carry or None, key=agg_key, mask=mask,
                weights=weights, with_diagnostics=True,
            )
            return tree_map(lambda u: scale * u, update), rpca_diag_summary(ediag), new_carry
        update = aggregate(deltas, agg_cfg, engine=engine, key=agg_key, mask=mask,
                           weights=weights, mesh=mesh, device=dev)
        return tree_map(lambda u: scale * u, update), {}

    agg_step.carry_on = carry_on
    return agg_step


def make_fed_train_step(
    cfg,
    agg_cfg: Optional[AggregatorConfig] = None,
    *,
    local_lr: float = 1e-4,
    local_steps: int = 1,
    local_optimizer: str = "sgd",
    remat: bool = True,
    microbatch: int = 1,
    engine: str = "packed",
    clients_per_round: int = 0,
    client_weights=None,
) -> Callable:
    """``(model, lora_global, batch, agg_key=None[, agg_carry]) ->
    (new_lora_global, metrics[, new_carry])``: ``make_local_step`` and
    ``make_agg_step`` back to back (the synchronous round)."""
    local_step = make_local_step(
        cfg, local_lr=local_lr, local_steps=local_steps, local_optimizer=local_optimizer,
        remat=remat, microbatch=microbatch, clients_per_round=clients_per_round,
    )
    agg_step = make_agg_step(agg_cfg, engine=engine, client_weights=client_weights)

    def fed_train_step(model, lora_global, batch, agg_key=None, agg_carry=None):
        deltas, loss, mask = local_step(model, lora_global, batch, agg_key)
        if agg_step.carry_on:
            upd, metrics, new_carry = agg_step(deltas, mask, agg_key, agg_carry)
            return apply_update(lora_global, upd), {"loss": loss, **metrics}, new_carry
        upd, metrics = agg_step(deltas, mask, agg_key)
        return apply_update(lora_global, upd), {"loss": loss, **metrics}

    return fed_train_step


def make_prefill_step(cfg) -> Callable:
    """``(model, lora, batch) -> (next_token_logits, caches)``."""

    def prefill_step(model, lora, batch):
        with torch.no_grad():
            logits, caches, _ = model_lib.forward(model, lora, batch, cfg, mode="prefill",
                                                  remat=False)
        return logits, caches

    return prefill_step


def make_serve_step(cfg) -> Callable:
    """``(model, lora, tokens (B, 1), caches, cache_index) -> (logits,
    caches)``; the caches are written in place."""

    def serve_step(model, lora, tokens, caches, cache_index):
        with torch.no_grad():
            return model_lib.decode_step(model, lora, tokens, caches, cache_index, cfg)

    return serve_step


def make_single_train_step(cfg, *, lr: float = 1e-4, remat: bool = True) -> Callable:
    """Non-federated LoRA train step (one SGD step):
    ``(model, lora, batch) -> (new_lora, loss)``."""

    def train_step(model, lora, batch):
        leaves = [p.detach().requires_grad_() for p in tree_leaves(lora)]
        live = tree_unflatten(lora, leaves)
        loss = model_lib.loss_fn(model, live, batch, cfg, remat=remat)[0]
        grads = torch.autograd.grad(loss, leaves)
        new = [(p - lr * g).detach() for p, g in zip(leaves, grads)]
        return tree_unflatten(lora, new), loss.detach()

    return train_step
