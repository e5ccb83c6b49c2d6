"""Public embedding-bag op: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors.  Unlike the JAX op it does not pad D to 128 lanes
(a TPU layout rule)."""

from __future__ import annotations

import torch

from repro_torch.kernels.embedding_bag import kernel, ref


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "mean") -> torch.Tensor:
    """Sum or mean of ``table[idx[b, l]]`` over l; (B, D) in the table's
    dtype."""
    if table.device.type == "cpu":
        kernel.check_args(table, idx, mode)
        return ref.embedding_bag(table, idx, mode=mode)
    return kernel.embedding_bag(table, idx, mode=mode)
