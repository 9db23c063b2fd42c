"""Client-side local optimization, batched over a leading client axis.

Port of ``repro/fed/client.py``.  The reference vmaps one client's
``lax.scan`` of minibatch steps; here all clients run as one computation
whose tensors carry a leading client axis.  Each step evaluates every
client's loss, sums them, and takes one backward pass: client c's
parameters enter only client c's loss, so the gradient of the sum is
exactly each client's own gradient.  The client-level baselines of the
paper compose with it, each per client:

  * FedProx  — proximal term  mu/2 * ||lora - lora_global||^2
  * SCAFFOLD — control variates: g <- g - c_i + c, with the option-II
               refresh c_i+ = c_i - c - delta / (K * lr)
  * MOON     — model-contrastive loss on ``feature_fn``:
               -log exp(sim(z, z_glob)/T) / (exp(sim(z, z_glob)/T)
                                             + exp(sim(z, z_prev)/T))

Minibatch indices are an input ((n_clients, local_steps, batch_size)
ints), not drawn here, so a caller can inject any index stream — the
server's own generator, or the reference's ``jax.random`` draws in a parity
test.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, NamedTuple, Optional

import torch

from repro_torch.optim import Optimizer
from repro_torch.optim.optimizers import apply_updates
from repro_torch.utils.pytree import tree_leaves, tree_map, tree_sub, tree_unflatten

Tree = Any


@dataclasses.dataclass(frozen=True)
class LocalSpec:
    # (base, lora, batch) -> (n_clients,) per-client losses, where lora
    # leaves and batch tensors carry a leading client axis.
    loss_fn: Callable
    optimizer: Optimizer
    local_steps: int
    batch_size: int
    lr: float  # needed by SCAFFOLD's variate refresh
    fedprox_mu: float = 0.0
    scaffold: bool = False
    moon_mu: float = 0.0
    moon_temp: float = 0.5
    # (base, lora, x) -> (n_clients, ...) features, for MOON; lora and x
    # carry the client axis.
    feature_fn: Optional[Callable] = None


class LocalResult(NamedTuple):
    lora: Tree  # (n_clients, ...) local models after the run
    delta: Tree  # lora - lora_global, per client
    new_ci: Tree  # SCAFFOLD variates (the input variates when SCAFFOLD is off)
    final_loss: torch.Tensor  # (n_clients,) total loss of each client's last step


def _per_client_sqnorm(tree: Tree) -> torch.Tensor:
    """(n,) squared norm of each client's slice, summed over every leaf."""
    total = None
    for x in tree_leaves(tree):
        s = torch.sum(torch.square(x).reshape(x.shape[0], -1), dim=1)
        total = s if total is None else total + s
    return total


def _broadcast(tree: Tree, n: int) -> Tree:
    return tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape), tree)


def make_local_fn(spec: LocalSpec) -> Callable:
    """Build the batched local optimization function.

    Signature: (base, lora_global, data_x, data_y, batch_idx, c=None,
    ci=None, prev_lora=None, active=None) -> LocalResult.
    ``lora_global`` is one model (no client axis); ``data_x``
    (n_clients, n_local, d_in), ``data_y`` (n_clients, n_local);
    ``batch_idx`` (n_clients, local_steps, batch_size) integer indices into
    each client's local data.  ``c`` is SCAFFOLD's server variate (one
    model) and ``ci`` the clients' variates (client axis); ``prev_lora``
    each client's previous local model (MOON).  None means zeros for the
    variates and the global model for ``prev_lora``.

    ``active`` (optional (n_clients,) 0/1) is the partial-participation
    early exit: only the active rows are gathered and optimized, and a
    masked row returns the global model, an exactly zero delta, its
    untouched variate and a loss of 0.  ``active=None`` runs every row.
    """

    def total_loss(base, lora, glob, prev, batch):
        loss = spec.loss_fn(base, lora, batch)
        if spec.fedprox_mu > 0:
            loss = loss + 0.5 * spec.fedprox_mu * _per_client_sqnorm(tree_sub(lora, glob))
        if spec.moon_mu > 0 and spec.feature_fn is not None:
            x = batch[0]
            z = spec.feature_fn(base, lora, x)
            with torch.no_grad():  # the reference's stop_gradient
                z_g = spec.feature_fn(base, glob, x)
                z_p = spec.feature_fn(base, prev, x)
            norm = lambda a: a / torch.clamp_min(torch.linalg.vector_norm(a, dim=-1, keepdim=True),
                                                 1e-9)
            z, z_g, z_p = norm(z), norm(z_g), norm(z_p)
            sim_g = torch.sum(z * z_g, dim=-1) / spec.moon_temp
            sim_p = torch.sum(z * z_p, dim=-1) / spec.moon_temp
            term = (sim_g - torch.logaddexp(sim_g, sim_p)).reshape(sim_g.shape[0], -1)
            loss = loss + spec.moon_mu * -torch.mean(term, dim=1)
        return loss

    def run(base, lora_global, data_x, data_y, batch_idx, c, ci, prev):
        n = data_x.shape[0]
        glob = _broadcast(lora_global, n)
        start = tree_map(lambda x: x.clone(), glob)
        lora = start
        opt_state = spec.optimizer.init(lora)
        rows = torch.arange(n, device=data_x.device)[:, None]
        losses = None
        for step in range(spec.local_steps):
            idx = batch_idx[:, step]
            batch = (data_x[rows, idx], data_y[rows, idx])
            params = tree_map(lambda t: t.detach().requires_grad_(True), lora)
            losses = total_loss(base, params, glob, prev, batch)
            grads = torch.autograd.grad(losses.sum(), tree_leaves(params))
            grads = tree_unflatten(params, list(grads))
            if spec.scaffold:
                grads = tree_map(lambda g, ci_, c_: g - ci_ + c_, grads, ci, c)
            updates, opt_state = spec.optimizer.update(grads, opt_state, lora)
            lora = apply_updates(lora, updates)
        lora = tree_map(lambda t: t.detach(), lora)
        delta = tree_sub(lora, start)
        if spec.scaffold:
            k_lr = spec.local_steps * spec.lr
            new_ci = tree_map(lambda ci_, c_, d: ci_ - c_ - d / k_lr, ci, c, delta)
        else:
            new_ci = ci
        return LocalResult(lora=lora, delta=delta, new_ci=new_ci,
                           final_loss=losses.detach().to(torch.float32))

    def local_optimize(base, lora_global, data_x, data_y, batch_idx, c=None, ci=None,
                       prev_lora=None, active=None):
        n = data_x.shape[0]
        if tuple(batch_idx.shape) != (n, spec.local_steps, spec.batch_size):
            raise ValueError(
                f"batch_idx shape {tuple(batch_idx.shape)} != "
                f"{(n, spec.local_steps, spec.batch_size)}"
            )
        if c is None:
            c = tree_map(torch.zeros_like, lora_global)
        if ci is None:
            ci = tree_map(lambda x: torch.zeros((n, *x.shape), dtype=x.dtype, device=x.device),
                          lora_global)
        if prev_lora is None:
            prev_lora = _broadcast(lora_global, n)
        if active is None:
            return run(base, lora_global, data_x, data_y, batch_idx, c, ci, prev_lora)

        # A CPU mask (the server's) picks the rows without a device read.
        rows = torch.nonzero(torch.as_tensor(active) > 0).flatten().to(data_x.device)
        take = lambda t: tree_map(lambda x: x.index_select(0, rows), t)
        lora = tree_map(lambda x: x.unsqueeze(0).repeat(n, *([1] * x.ndim)), lora_global)
        delta = tree_map(torch.zeros_like, lora)
        new_ci = tree_map(lambda x: x.clone(), ci)
        loss = torch.zeros((n,), dtype=torch.float32, device=data_x.device)
        if rows.numel():
            sub = run(base, lora_global, data_x.index_select(0, rows),
                      data_y.index_select(0, rows),
                      batch_idx.index_select(0, rows.to(batch_idx.device)), c, take(ci),
                      take(prev_lora))
            put = lambda full, part: tree_map(lambda f, p: f.index_copy_(0, rows, p), full, part)
            put(lora, sub.lora)
            put(delta, sub.delta)
            put(new_ci, sub.new_ci)
            loss.index_copy_(0, rows, sub.final_loss)
        return LocalResult(lora=lora, delta=delta, new_ci=new_ci, final_loss=loss)

    return local_optimize
