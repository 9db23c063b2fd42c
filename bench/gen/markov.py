"""Heterogeneous Markov-chain token clients (a frozen copy of the
program's synthetic corpus generator, numpy only, the same bits from one
seed).

Client i's chain is (1 - h) base + h base[perm][:, perm] over a vocabulary
of ``vocab`` ids, each row normalized, with the base transition matrix
sparse and peaked; sequences start at a uniform id.  Only the rows the
chains visit are formed.
"""
from __future__ import annotations

import numpy as np


def _markov_tokens(rng, rows_of, n_seqs: int, seq_len: int, vocab: int) -> np.ndarray:
    out = np.empty((n_seqs, seq_len + 1), np.int32)
    out[:, 0] = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        u = rng.random(n_seqs)
        rows = np.cumsum(rows_of(out[:, t]), axis=1)
        out[:, t + 1] = (u[:, None] < rows).argmax(axis=1)
    return out


def _base_transition(rng, vocab: int, peak: float = 0.6) -> np.ndarray:
    trans = rng.random((vocab, vocab)) ** 4
    top = rng.integers(0, vocab, size=(vocab, 3))
    for i in range(vocab):
        trans[i, top[i]] += peak * vocab / 3
    return trans / trans.sum(axis=1, keepdims=True)


def client_tokens(n_clients: int, vocab: int, n_seqs: int, seq_len: int,
                  heterogeneity: float, seed: int) -> np.ndarray:
    """(n_clients, n_seqs, seq_len + 1) int32 token ids."""
    rng = np.random.default_rng(seed)
    base = _base_transition(rng, vocab)
    out = []
    for i in range(n_clients):
        perm = rng.permutation(vocab)

        def rows(idx, perm=perm):
            r = (1 - heterogeneity) * base[idx] + heterogeneity * base[perm[idx]][:, perm]
            return r / r.sum(axis=1, keepdims=True)

        out.append(_markov_tokens(np.random.default_rng(seed + 100 + i), rows, n_seqs,
                                  seq_len, vocab))
    return np.stack(out)
