"""SGD / Adam / AdamW as ``Optimizer(init, update)`` pairs over trees.

Port of ``repro/optim/optimizers.py``, with the same contract:

    state = opt.init(params)
    updates, state = opt.update(grads, state, params)
    params = apply_updates(params, updates)

Tensors may carry a leading client axis: every update is elementwise, so one
call serves a whole batch of clients.  The step counter is a Python int.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple

import torch

from repro_torch.utils.pytree import tree_map

Tree = Any


class Optimizer(NamedTuple):
    init: Callable[[Tree], Tree]
    update: Callable[..., tuple]  # (grads, state, params) -> (updates, state)


def apply_updates(params: Tree, updates: Tree) -> Tree:
    return tree_map(lambda p, u: p + u.to(p.dtype), params, updates)


def sgd(lr, momentum: float = 0.0) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        state = {"step": 0}
        if momentum:
            state["mu"] = tree_map(torch.zeros_like, params)
        return state

    def update(grads, state, params=None):
        step = state["step"]
        lr_t = lr_fn(step)
        if momentum:
            mu = tree_map(lambda m, g: momentum * m + g, state["mu"], grads)
            return tree_map(lambda m: -lr_t * m, mu), {"step": step + 1, "mu": mu}
        return tree_map(lambda g: -lr_t * g, grads), {"step": step + 1}

    return Optimizer(init, update)


def _adam_core(lr, b1, b2, eps, weight_decay) -> Optimizer:
    lr_fn = lr if callable(lr) else (lambda _: lr)

    def init(params):
        zeros = lambda: tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32), params)
        return {"step": 0, "m": zeros(), "v": zeros()}

    def update(grads, state, params=None):
        step = state["step"] + 1
        lr_t = lr_fn(step)
        m = tree_map(lambda m_, g: b1 * m_ + (1 - b1) * g.to(torch.float32), state["m"], grads)
        v = tree_map(
            lambda v_, g: b2 * v_ + (1 - b2) * torch.square(g.to(torch.float32)), state["v"], grads
        )
        # float32 bias corrections, as the reference computes them.
        step_f = torch.tensor(float(step), dtype=torch.float32)
        bc1 = float(1 - torch.tensor(b1, dtype=torch.float32) ** step_f)
        bc2 = float(1 - torch.tensor(b2, dtype=torch.float32) ** step_f)

        def upd(m_, v_, p=None):
            u = -(lr_t * (m_ / bc1) / (torch.sqrt(v_ / bc2) + eps))
            if weight_decay and p is not None:
                u = u - lr_t * weight_decay * p.to(torch.float32)
            return u

        if weight_decay and params is not None:
            updates = tree_map(upd, m, v, params)
        else:
            updates = tree_map(upd, m, v)
        return updates, {"step": step, "m": m, "v": v}

    return Optimizer(init, update)


def adam(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, 0.0)


def adamw(lr, b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
          weight_decay: float = 0.1) -> Optimizer:
    return _adam_core(lr, b1, b2, eps, weight_decay)


def make_optimizer(name: str, lr, weight_decay: float = 0.0) -> Optimizer:
    if name == "sgd":
        return sgd(lr)
    if name == "adam":
        return adam(lr)
    if name == "adamw":
        return adamw(lr, weight_decay=weight_decay or 0.1)
    raise ValueError(f"unknown optimizer {name!r}")
