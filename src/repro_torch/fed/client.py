"""Client-side local optimization, batched over a leading client axis.

Port of ``repro/fed/client.py``.  The reference vmaps one client's
``lax.scan`` of minibatch steps; here all clients run as one computation
whose tensors carry a leading client axis.  Each step evaluates every
client's loss, sums them, and takes one backward pass: client c's
parameters enter only client c's loss, so the gradient of the sum is
exactly each client's own gradient.

Minibatch indices are an input ((n_clients, local_steps, batch_size)
ints), not drawn here, so a caller can inject any index stream — the
server's own generator, or the reference's ``jax.random`` draws in a parity
test.  FedProx, SCAFFOLD and MOON raise until ROADMAP.md queue 1, item 4.
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
    lr: float
    fedprox_mu: float = 0.0
    scaffold: bool = False
    moon_mu: float = 0.0
    moon_temp: float = 0.5
    feature_fn: Optional[Callable] = None  # (base, lora, x) -> features, for MOON


class LocalResult(NamedTuple):
    lora: Tree  # (n_clients, ...) local models after the run
    delta: Tree  # lora - lora_global, per client
    new_ci: Tree  # SCAFFOLD variates (zeros: SCAFFOLD is not ported yet)
    final_loss: torch.Tensor  # (n_clients,) loss of each client's last step


def make_local_fn(spec: LocalSpec) -> Callable:
    """Build the batched local optimization function.

    Signature: (base, lora_global, data_x, data_y, batch_idx) ->
    LocalResult.  ``lora_global`` is one model (no client axis);
    ``data_x`` (n_clients, n_local, d_in), ``data_y`` (n_clients, n_local);
    ``batch_idx`` (n_clients, local_steps, batch_size) integer indices into
    each client's local data.
    """
    if spec.fedprox_mu > 0 or spec.scaffold or spec.moon_mu > 0:
        raise NotImplementedError(
            "FedProx, SCAFFOLD and MOON local objectives are not ported yet "
            "(ROADMAP.md queue 1, item 4)"
        )

    def local_optimize(base, lora_global, data_x, data_y, batch_idx):
        n = data_x.shape[0]
        if tuple(batch_idx.shape) != (n, spec.local_steps, spec.batch_size):
            raise ValueError(
                f"batch_idx shape {tuple(batch_idx.shape)} != "
                f"{(n, spec.local_steps, spec.batch_size)}"
            )
        start = tree_map(lambda x: x.unsqueeze(0).expand(n, *x.shape).clone(), lora_global)
        lora = start
        opt_state = spec.optimizer.init(lora)
        rows = torch.arange(n, device=data_x.device)[:, None]
        losses = None
        for step in range(spec.local_steps):
            idx = batch_idx[:, step]
            batch = (data_x[rows, idx], data_y[rows, idx])
            params = tree_map(lambda t: t.detach().requires_grad_(True), lora)
            losses = spec.loss_fn(base, params, batch)
            grads = torch.autograd.grad(losses.sum(), tree_leaves(params))
            grads = tree_unflatten(params, list(grads))
            updates, opt_state = spec.optimizer.update(grads, opt_state, lora)
            lora = apply_updates(lora, updates)
        lora = tree_map(lambda t: t.detach(), lora)
        return LocalResult(
            lora=lora,
            delta=tree_sub(lora, start),
            new_ci=tree_map(torch.zeros_like, lora),
            final_loss=losses.detach().to(torch.float32),
        )

    return local_optimize
