"""Synthetic LM corpora for the end-to-end runs and smoke tests (a copy
of ``repro/data/synthetic.py``: pure numpy, the same bits from one seed).

Sequences are drawn from per-client first-order Markov chains over the
vocabulary: a *shared* base transition matrix (common signal) interpolated
with a client-specific permutation (client-specific signal).  A model that
only learns the shared chain plateaus; heterogeneous clients carry learnable
structure — the LM analogue of the planted classification task.
"""
from __future__ import annotations

from typing import Iterator, List, NamedTuple, Tuple

import numpy as np


class SyntheticLM(NamedTuple):
    tokens: np.ndarray  # (n_seqs, seq_len + 1) int32
    vocab_size: int


def _markov_tokens(
    rng: np.random.Generator,
    trans: np.ndarray,
    n_seqs: int,
    seq_len: int,
) -> np.ndarray:
    v = trans.shape[0]
    out = np.empty((n_seqs, seq_len + 1), np.int32)
    out[:, 0] = rng.integers(0, v, size=n_seqs)
    cdf = np.cumsum(trans, axis=1)
    for t in range(seq_len):
        u = rng.random(n_seqs)
        rows = cdf[out[:, t]]
        out[:, t + 1] = (u[:, None] < rows).argmax(axis=1)
    return out


def _base_transition(rng: np.random.Generator, vocab: int, peak: float = 0.6) -> np.ndarray:
    trans = rng.random((vocab, vocab)) ** 4
    # Sparse, peaked rows: each token has a few likely successors.
    top = rng.integers(0, vocab, size=(vocab, 3))
    for i in range(vocab):
        trans[i, top[i]] += peak * vocab / 3
    return trans / trans.sum(axis=1, keepdims=True)


def make_lm_data(
    vocab_size: int = 256,
    n_seqs: int = 256,
    seq_len: int = 128,
    seed: int = 0,
) -> SyntheticLM:
    rng = np.random.default_rng(seed)
    trans = _base_transition(rng, vocab_size)
    return SyntheticLM(_markov_tokens(rng, trans, n_seqs, seq_len), vocab_size)


def client_lm_datasets(
    n_clients: int,
    vocab_size: int = 256,
    n_seqs: int = 64,
    seq_len: int = 128,
    heterogeneity: float = 0.5,
    seed: int = 0,
) -> Tuple[np.ndarray, SyntheticLM]:
    """Returns (client_tokens (M, n_seqs, L+1), shared test set)."""
    rng = np.random.default_rng(seed)
    base = _base_transition(rng, vocab_size)
    client_tokens = []
    for i in range(n_clients):
        perm = rng.permutation(vocab_size)
        client_trans = (1 - heterogeneity) * base + heterogeneity * base[perm][:, perm]
        client_trans /= client_trans.sum(axis=1, keepdims=True)
        client_tokens.append(
            _markov_tokens(np.random.default_rng(seed + 100 + i), client_trans, n_seqs, seq_len)
        )
    test = SyntheticLM(
        _markov_tokens(np.random.default_rng(seed + 1), base, n_seqs, seq_len), vocab_size
    )
    return np.stack(client_tokens), test


def make_lm_batches(
    data: SyntheticLM, batch_size: int, seed: int = 0
) -> Iterator[dict]:
    """Infinite iterator of {"tokens", "labels"} next-token batches."""
    rng = np.random.default_rng(seed)
    n = data.tokens.shape[0]
    while True:
        idx = rng.integers(0, n, size=batch_size)
        seqs = data.tokens[idx]
        yield {"tokens": seqs[:, :-1], "labels": seqs[:, 1:]}
