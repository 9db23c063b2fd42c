"""Planted client deltas for the server's side of a round: per module a
common low-rank part that drifts from round to round, a client-specific
sparse part and dense noise, made on the device from (seed, round).

Module m of a (L, vec, n) block at round r:

    common = (cos(theta r) U0 + sin(theta r) U1) C       rank ``rank``
    C      = c0 1^T + client_spread N(0, 1)               shared mixing
    sparse = Bernoulli(density) * N(0, sparse_scale^2 rms(common)^2)
    noise  = N(0, 1) scaled to ``noise`` ||common||

U0, U1 (vec, rank) and C (rank, n) are drawn once from the seed, so the
common part moves by about ``drift`` of its norm a round (theta = drift),
and the clients' common parts share the mixing c0, so that their deltas
point the same way (the paper's premise);
the sparse positions and values and the noise are drawn anew each round.
Everything is scaled so that rms(common) is ``scale``.  The mix may give
the adapters' A and B factors parameters of their own (``by_factor``);
``bench/fit_traffic.py`` fits them to the program's own client deltas.
"""
from __future__ import annotations

import math

import torch

from bench.gen.weights import generator


def params_for(p: dict, name) -> dict:
    """The planted parameters of block ``name`` (a (target, factor) pair):
    the mix's, with the entry of ``p["by_factor"]`` for that factor over
    them."""
    base = {k: v for k, v in p.items() if k != "by_factor"}
    factor = name[1] if isinstance(name, tuple) else None
    return {**base, **p.get("by_factor", {}).get(factor, {})}


class Planted:
    def __init__(self, blocks: dict, n_clients: int, p: dict, seed: int, device):
        """``blocks``: {name: (L, vec)}; ``p``: the mix's ``planted``
        parameters."""
        self.blocks, self.n, self.seed, self.device = blocks, n_clients, seed, device
        self.p = {name: params_for(p, name) for name in blocks}
        g = generator(device, seed, "planted")
        self.basis = {}
        for name, (n_l, vec) in blocks.items():
            q = self.p[name]
            k = q["rank"]
            u = torch.randn((2, n_l, vec, k), generator=g, device=device)
            c0 = torch.randn((n_l, k, 1), generator=g, device=device)
            c = c0 + q["client_spread"] * torch.randn((n_l, k, n_clients), generator=g,
                                                      device=device)
            self.basis[name] = (u[0], u[1], c)

    def round(self, r: int) -> dict:
        """{name: (L, vec, n_clients) float32} of round ``r``."""
        g = generator(self.device, self.seed, f"round{r}")
        out = {}
        for name, (u0, u1, c) in self.basis.items():
            p = self.p[name]
            th = p["drift"] * r
            common = (math.cos(th) * u0 + math.sin(th) * u1) @ c
            rms = torch.sqrt(torch.mean(common * common, dim=(1, 2), keepdim=True))
            common = common * (p["scale"] / rms)
            mask = torch.rand(common.shape, generator=g, device=self.device) < p["density"]
            sparse = torch.randn(common.shape, generator=g, device=self.device) * mask
            noise = torch.randn(common.shape, generator=g, device=self.device)
            nrm = lambda t: torch.sqrt(torch.sum(t * t, dim=(1, 2), keepdim=True))
            noise = noise * (p["noise"] * nrm(common) / nrm(noise))
            out[name] = common + p["sparse_scale"] * p["scale"] * sparse + noise
        return out


def mean_pairwise_cosine(blocks: dict) -> float:
    """Mean cosine similarity over pairs of clients of their whole deltas."""
    x = torch.cat([b.reshape(-1, b.shape[-1]) for b in blocks.values()], dim=0).double()
    x = x / torch.linalg.vector_norm(x, dim=0, keepdim=True)
    sim = x.T @ x
    n = sim.shape[0]
    return float((sim.sum() - sim.diagonal().sum()) / (n * (n - 1)))
