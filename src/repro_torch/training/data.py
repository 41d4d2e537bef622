"""Synthetic LM data pipeline: deterministic, seedable token streams (a
copy of ``repro/training/data.py``, numpy only, so that the same seed
gives both packages the same batches).

Sequences follow a order-2 Markov process over the vocabulary so models
have learnable structure (loss decreases measurably within a few hundred
steps on a ~100M model), plus an infinite batch iterator with sharding-
friendly global batches.
"""
from __future__ import annotations

import numpy as np


class MarkovTextStream:
    def __init__(self, vocab: int, seed: int = 0, branching: int = 8):
        rng = np.random.default_rng(seed)
        self.vocab = vocab
        self.branching = min(branching, vocab)
        # transition table: each context maps to `branching` likely tokens
        self.table = rng.integers(0, vocab, size=(vocab, self.branching))
        self.rng = rng

    def sample_batch(self, batch: int, seq_len: int) -> np.ndarray:
        out = np.empty((batch, seq_len + 1), np.int32)
        cur = self.rng.integers(0, self.vocab, size=batch)
        for t in range(seq_len + 1):
            out[:, t] = cur
            nxt_idx = self.rng.integers(0, self.branching, size=batch)
            jump = self.rng.random(batch) < 0.1     # 10% random restarts
            cur = np.where(jump,
                           self.rng.integers(0, self.vocab, size=batch),
                           self.table[cur, nxt_idx])
        return out


def batches(vocab: int, batch: int, seq_len: int, seed: int = 0):
    """Yields dicts {tokens (B,S), labels (B,S)} forever."""
    stream = MarkovTextStream(vocab, seed)
    while True:
        chunk = stream.sample_batch(batch, seq_len)
        yield {"tokens": chunk[:, :-1], "labels": chunk[:, 1:]}
