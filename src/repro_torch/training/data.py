"""Synthetic token streams (the port of two functions of the JAX package's
``training/data.py``; numpy only, so the arrays are equal to JAX's for the
same arguments).

``synthetic_batch`` is uniform-random tokens, deterministic per step;
``bigram_batch`` follows a fixed random bigram (Markov) chain, so the
stream has low conditional entropy: the kNN-LM example and the card's LM
phase index (state, next token) pairs over it.
"""

from __future__ import annotations

import numpy as np


def synthetic_batch(step: int, batch: int, seq: int, vocab: int,
                    seed: int = 0):
    """Deterministic synthetic LM batch for step N (replayable)."""
    rng = np.random.default_rng(np.uint64(seed * 1_000_003 + step))
    tokens = rng.integers(0, vocab, (batch, seq + 1), dtype=np.int32)
    return {"tokens": tokens[:, :-1], "labels": tokens[:, 1:]}


def bigram_batch(step: int, batch: int, seq: int, vocab: int, seed: int = 0):
    """Learnable synthetic LM data: a fixed random bigram (Markov) chain."""
    master = np.random.default_rng(seed)
    # each token deterministically maps to a small candidate set
    nexts = master.integers(0, vocab, (vocab, 4))
    rng = np.random.default_rng(np.uint64(seed * 999_983 + step + 1))
    tok = np.empty((batch, seq + 1), np.int32)
    tok[:, 0] = rng.integers(0, vocab, batch)
    choices = rng.integers(0, 4, (batch, seq))
    for t in range(seq):
        tok[:, t + 1] = nexts[tok[:, t], choices[:, t]]
    return {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
