"""Plain PyTorch version of the embedding-bag kernel: gather the rows of each
bag, optionally weight them, and sum or average over the bag."""

from __future__ import annotations

import torch


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "mean", weights: torch.Tensor | None = None
                  ) -> torch.Tensor:
    """table: (V, D); idx: (B, L) integer; weights: optional (B, L).
    Returns (B, D) in the table's dtype."""
    rows = table[idx.long()]                 # (B, L, D)
    if weights is not None:
        rows = rows * weights[..., None]
    if mode == "sum":
        return rows.sum(dim=1)
    if mode == "mean":
        return rows.mean(dim=1)
    raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
