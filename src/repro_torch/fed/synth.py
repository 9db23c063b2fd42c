"""Planted-signal synthetic federated tasks.

Port of ``repro/fed/synth.py``.  The task data comes from the same numpy
draws as the reference (same seed, same arrays); only ``init_lora`` draws
from a ``torch.Generator`` (the reference draws from ``jax.random``, so a
parity test passes the reference's LoRA init across instead).

Model: logits = tanh(x @ (W0 + s * A @ B)) @ H, trainable (A, B) only.  A
LoRA tree may carry a leading client axis — ``A (n, d_in, r)``,
``B (n, r, d_feat)`` — and every function here then works per client.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.fed.partition import dirichlet_partition


class SynthTask(NamedTuple):
    base: dict  # frozen: {"W0": (d_in, d_feat), "H": (d_feat, C)}
    client_x: torch.Tensor  # (M, n_local, d_in)
    client_y: torch.Tensor  # (M, n_local) int64
    test_x: torch.Tensor
    test_y: torch.Tensor
    n_classes: int
    lora_rank: int
    lora_scale: float


def make_synth_task(
    *,
    n_clients: int = 16,
    n_classes: int = 20,
    d_in: int = 64,
    d_feat: int = 64,
    n_per_client: int = 64,
    n_test: int = 1024,
    alpha: float = 0.3,
    lora_rank: int = 4,
    lora_alpha: float = 8.0,
    pretrain_quality: float = 0.5,
    domain_shift_scale: float = 1.0,
    noise: float = 0.35,
    seed: int = 0,
    device="cpu",
) -> SynthTask:
    """Same generative story and the same numpy draws as the reference;
    tensors land on ``device``."""
    rng = np.random.default_rng(seed)
    z, _ = np.linalg.qr(rng.normal(size=(d_feat, d_feat)))
    z = z[:, :n_classes]
    head = z
    g_mix = rng.normal(size=(d_in, d_feat)) / np.sqrt(d_feat)
    shift = rng.normal(size=(d_in,)) * domain_shift_scale / np.sqrt(d_in)
    g_pinv = np.linalg.pinv(g_mix)
    w0 = pretrain_quality * g_pinv.T + (1 - pretrain_quality) * rng.normal(
        size=(d_in, d_feat)
    ) / np.sqrt(d_in)

    def sample(labels: np.ndarray) -> np.ndarray:
        zc = z[:, labels].T
        return zc @ g_mix.T + shift[None, :] + noise * rng.normal(size=(len(labels), d_in))

    n_train = n_clients * n_per_client * 2
    train_labels = rng.integers(0, n_classes, size=n_train)
    parts = dirichlet_partition(train_labels, n_clients, alpha, rng, min_per_client=4)
    cx, cy = [], []
    for ix in parts:
        chosen = rng.choice(ix, size=n_per_client, replace=len(ix) < n_per_client)
        labels = train_labels[chosen]
        cx.append(sample(labels))
        cy.append(labels)
    test_labels = rng.integers(0, n_classes, size=n_test)

    f32 = lambda a: torch.as_tensor(np.asarray(a, np.float32), device=device)
    i64 = lambda a: torch.as_tensor(np.asarray(a, np.int64), device=device)
    return SynthTask(
        base={"W0": f32(w0), "H": f32(head)},
        client_x=f32(np.stack(cx)),
        client_y=i64(np.stack(cy)),
        test_x=f32(sample(test_labels)),
        test_y=i64(test_labels),
        n_classes=n_classes,
        lora_rank=lora_rank,
        lora_scale=lora_alpha / lora_rank,
    )


def init_lora(task: SynthTask, generator: torch.Generator | None = None, seed: int = 0) -> dict:
    """A ~ N(0, 1/d_in), B = 0, drawn on the CPU from ``generator`` (or a
    fresh one seeded with ``seed``) so the same seed gives the same weights
    on every device; the tensors land on the task's device."""
    if generator is None:
        generator = torch.Generator().manual_seed(seed)
    d_in, d_feat = task.base["W0"].shape
    dev = task.base["W0"].device
    a = torch.randn((d_in, task.lora_rank), generator=generator) / np.sqrt(d_in)
    return {
        "A": a.to(torch.float32).to(dev),
        "B": torch.zeros((task.lora_rank, d_feat), dtype=torch.float32, device=dev),
    }


def features(base: dict, lora: dict, x: torch.Tensor, scale: float) -> torch.Tensor:
    """tanh(x @ (W0 + s A B)); with a leading client axis on the LoRA and on
    ``x`` ((n, batch, d_in)), per client."""
    w = base["W0"] + scale * (lora["A"] @ lora["B"])
    return torch.tanh(x @ w)


def _logits(base, lora, x, scale):
    return features(base, lora, x, scale) @ base["H"]


def loss_fn(base: dict, lora: dict, batch, scale: float) -> torch.Tensor:
    """Mean cross-entropy over the batch (per client with a client axis)."""
    x, y = batch
    logp = torch.log_softmax(_logits(base, lora, x, scale), dim=-1)
    return -torch.mean(torch.gather(logp, -1, y.long()[..., None])[..., 0], dim=-1)


def accuracy(base: dict, lora: dict, x: torch.Tensor, y: torch.Tensor, scale: float) -> torch.Tensor:
    logits = _logits(base, lora, x, scale)
    return torch.mean((torch.argmax(logits, dim=-1) == y).to(torch.float32), dim=-1)
