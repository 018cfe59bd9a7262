"""Synthetic token data with learnable structure.

A fixed random affine recurrence over tokens (t_{i+1} = (a * t_i + b) % V
with per-position noise) gives a corpus with real conditional entropy — a
model that learns drops loss well below log V, so the end-to-end example
demonstrably trains (quickstart asserts it).
"""
from __future__ import annotations

import numpy as np


def synthetic_corpus(n_tokens: int, vocab: int, seed: int = 0,
                     noise: float = 0.1) -> np.ndarray:
    rng = np.random.default_rng(seed)
    a = int(rng.integers(2, vocab - 1)) | 1
    b = int(rng.integers(1, vocab - 1))
    t = np.empty(n_tokens, np.int32)
    t[0] = rng.integers(0, vocab)
    for i in range(1, n_tokens):
        if rng.random() < noise:
            t[i] = rng.integers(0, vocab)
        else:
            t[i] = (a * int(t[i - 1]) + b) % vocab
    return t


def synthetic_batch(rng: np.random.Generator, corpus: np.ndarray,
                    batch: int, seq: int) -> dict:
    starts = rng.integers(0, corpus.size - seq - 1, batch)
    toks = np.stack([corpus[s: s + seq] for s in starts])
    return {"tokens": toks.astype(np.int32)}
