"""Synthetic LM token pipeline: deterministic, shardable, restart-safe (a
copy of the JAX package's ``data/tokens.py``, which is numpy only).

Zipf-distributed tokens with a simple induced structure (each token biases
the next) so cross-entropy actually decreases during the example training
runs.  Batches are generated per (step, shard): any host can reproduce any
shard's batch, so a restart or a re-shard replays the exact stream.
"""

from __future__ import annotations

import numpy as np


class TokenStream:
    def __init__(self, vocab: int, seq_len: int, global_batch: int,
                 seed: int = 0, zipf_a: float = 1.2):
        self.vocab = vocab
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        self.zipf_a = zipf_a
        rng = np.random.default_rng(seed)
        ranks = np.arange(1, vocab + 1, dtype=np.float64)
        self.probs = ranks ** (-zipf_a)
        self.probs /= self.probs.sum()
        # deterministic "grammar": token t prefers successor perm[t]
        self.perm = rng.permutation(vocab)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        """The (step, shard) batch — identical regardless of which host asks:
        ``tokens`` and ``labels`` (the tokens shifted by one), (B, S) int32
        numpy arrays."""
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 1_000_003 + step) * 65_537 + shard)
        toks = np.empty((b, self.seq_len + 1), np.int32)
        toks[:, 0] = rng.choice(self.vocab, size=b, p=self.probs)
        follow = rng.random((b, self.seq_len)) < 0.5
        rand_next = rng.choice(self.vocab, size=(b, self.seq_len),
                               p=self.probs)
        for t in range(self.seq_len):
            toks[:, t + 1] = np.where(
                follow[:, t], self.perm[toks[:, t]], rand_next[:, t])
        return {
            "tokens": toks[:, :-1],
            "labels": toks[:, 1:].astype(np.int32),
        }
