"""The reference federated round: every client takes ``local_steps`` plain
Adam steps on its own batch from the global adapter (``decoder``), the
deltas are aggregated by the plain FedRPCA session (``rpca``), and the
update is added to the global.  One client at a time, float32, so that it
fits beside nothing else on the card."""
from __future__ import annotations

import torch

from bench.reference import decoder, rpca


def _flat(lora_layers: list, targets) -> list:
    return [lo[t][f] for lo in lora_layers for t in targets for f in ("A", "B")]


def _unflat(flat: list, n_layers: int, targets) -> list:
    it = iter(flat)
    return [{t: {f: next(it) for f in ("A", "B")} for t in targets} for _ in range(n_layers)]


def to_layers(lora: dict) -> list:
    """{target: {"A": (L, ...), "B"}} -> per-layer [{target: {"A", "B"}}]."""
    n = next(iter(lora.values()))["A"].shape[0]
    return [{t: {f: lora[t][f][i] for f in ("A", "B")} for t in lora} for i in range(n)]


def local_phase(weights, glob: list, batch_tokens, spec, lr: float, steps: int, quant=None):
    """Per-client (losses of the last step, first-step gradients, per-layer
    deltas).
    ``batch_tokens`` is (M, P, S + 1)."""
    targets = sorted(glob[0])
    start = _flat(glob, targets)
    losses, grads1, deltas = [], [], []
    for c in range(batch_tokens.shape[0]):
        tok, lab = batch_tokens[c, :, :-1], batch_tokens[c, :, 1:]
        params = [p.detach().clone() for p in start]
        opt = decoder.Adam(params, lr)
        loss = None
        for k in range(steps):
            live = [p.detach().requires_grad_() for p in params]
            loss = decoder.client_loss(weights, _unflat(live, len(glob), targets), tok, lab,
                                       spec, quant)
            grads = torch.autograd.grad(loss, live)
            if k == 0:
                grads1.append(_unflat(list(grads), len(glob), targets))
            params = opt.step([p.detach() for p in live], grads)
        losses.append(float(loss.detach()))
        deltas.append(_unflat([p - s for p, s in zip(params, start)], len(glob), targets))
    return losses, grads1, deltas


def stack_modules(deltas: list, targets) -> list:
    """Client deltas (per client, per layer) -> one (vec, n_clients) matrix
    a (target, factor, layer), in ``weights.modules`` order."""
    n_layers = len(deltas[0])
    out = []
    for t in targets:
        for f in ("A", "B"):
            for i in range(n_layers):
                out.append(torch.stack([d[i][t][f].reshape(-1) for d in deltas], dim=1))
    return out


def apply_modules(glob: list, updates: list, targets) -> list:
    n_layers = len(glob)
    it = iter(updates)
    new = [{t: dict(lo[t]) for t in targets} for lo in glob]
    for t in targets:
        for f in ("A", "B"):
            for i in range(n_layers):
                u = next(it)
                new[i][t][f] = glob[i][t][f] + u.to(glob[i][t][f].dtype).view_as(glob[i][t][f])
    return new
