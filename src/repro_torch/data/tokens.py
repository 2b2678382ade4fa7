"""Synthetic LM data pipeline: deterministic, seekable token streams.

Determinism matters for fault tolerance: batch(step) is a pure function of
(seed, step), so a restarted job resumes mid-stream bit-exactly — no
shuffle-buffer state to snapshot.  The stream is a mixture of Zipf-ish
unigram noise and copied spans so reduced models have something learnable.
"""
from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, batch: int, seq_len: int, seed: int = 0):
        self.vocab = vocab
        self.batch = batch
        self.seq_len = seq_len
        self.seed = seed

    def batch_at(self, step: int) -> dict:
        rng = np.random.default_rng((self.seed << 20) ^ step)
        B, S, V = self.batch, self.seq_len, self.vocab
        # zipf-ish marginal over the vocab
        u = rng.random((B, S + 1))
        toks = ((V - 1) * u ** 3).astype(np.int32) + 1
        # inject copy spans: second half repeats the first (learnable signal)
        half = (S + 1) // 2
        toks[:, half: 2 * half] = toks[:, :half]
        return {
            "tokens": toks[:, :-1],
            "targets": toks[:, 1:],
            "mask": np.ones((B, S), np.float32),
        }

    def __iter__(self):
        step = 0
        while True:
            yield self.batch_at(step)
            step += 1
