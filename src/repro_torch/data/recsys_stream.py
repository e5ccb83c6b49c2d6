"""Synthetic DIN batches (port of the JAX package's
``data/recsys_stream.py``, array for array): Zipf-like item popularity,
a random category per item, and a click label that follows how often the
candidate's category appears in the history (so target attention has a
signal to learn); deterministic per (step, shard) like the token stream.
Host numpy."""

from __future__ import annotations

import numpy as np


class RecsysStream:
    def __init__(self, n_items: int, n_cats: int, seq_len: int,
                 global_batch: int, seed: int = 0):
        self.n_items = n_items
        self.n_cats = n_cats
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.seed = seed
        rng = np.random.default_rng(seed)
        self.item_cat = rng.integers(0, n_cats, n_items).astype(np.int32)

    def _items(self, rng, shape):
        # Zipf-like through a Pareto floor
        r = rng.pareto(1.3, shape) + 1
        return np.minimum((r * 17).astype(np.int64),
                          self.n_items - 1).astype(np.int32)

    def batch(self, step: int, shard: int = 0, n_shards: int = 1) -> dict:
        b = self.global_batch // n_shards
        rng = np.random.default_rng(
            (self.seed * 9_999_991 + step) * 65_537 + shard)
        hist = self._items(rng, (b, self.seq_len))
        cand = self._items(rng, (b,))
        # click iff the candidate's category is frequent in the history
        same = (self.item_cat[hist] == self.item_cat[cand][:, None]).mean(1)
        label = (same + rng.normal(0, 0.1, b) > 0.12).astype(np.float32)
        return {
            "hist_items": hist,
            "hist_cats": self.item_cat[hist],
            "cand_item": cand,
            "cand_cat": self.item_cat[cand],
            "hist_mask": np.ones((b, self.seq_len), np.float32),
            "label": label,
        }

    def retrieval_batch(self, n_candidates: int, seed: int = 0) -> dict:
        rng = np.random.default_rng(seed)
        hist = self._items(rng, (1, self.seq_len))
        cands = self._items(rng, (n_candidates,))
        return {
            "hist_items": hist,
            "hist_cats": self.item_cat[hist],
            "hist_mask": np.ones((1, self.seq_len), np.float32),
            "cand_items": cands,
            "cand_cats": self.item_cat[cands],
        }
