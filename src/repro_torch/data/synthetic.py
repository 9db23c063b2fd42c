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
    trans,
    n_seqs: int,
    seq_len: int,
    vocab: int | None = None,
) -> np.ndarray:
    """Sequences of a Markov chain: ``trans`` is the (V, V) transition
    matrix, or a function from a vector of states to their rows (with
    ``vocab`` = V), so that only the rows the chains visit are formed.
    Each row's cumulative sum is the one the whole matrix's would give."""
    if callable(trans):
        rows_of = trans
    else:
        vocab = trans.shape[0]
        rows_of = lambda idx: trans[idx]
    out = np.empty((n_seqs, seq_len + 1), np.int32)
    out[:, 0] = rng.integers(0, vocab, size=n_seqs)
    for t in range(seq_len):
        u = rng.random(n_seqs)
        rows = np.cumsum(rows_of(out[:, t]), axis=1)
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
    """Returns (client_tokens (M, n_seqs, L+1), shared test set).

    Client i's chain is (1 - h) base + h base[perm][:, perm], each row
    normalized; its rows are formed as the chains visit them."""
    rng = np.random.default_rng(seed)
    base = _base_transition(rng, vocab_size)
    client_tokens = []
    for i in range(n_clients):
        perm = rng.permutation(vocab_size)

        def rows(idx, perm=perm):
            r = (1 - heterogeneity) * base[idx] + heterogeneity * base[perm[idx]][:, perm]
            return r / r.sum(axis=1, keepdims=True)

        client_tokens.append(_markov_tokens(np.random.default_rng(seed + 100 + i), rows,
                                            n_seqs, seq_len, vocab_size))
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
