"""Support wrappers around the dense triangle-count kernel."""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.kernels import check_kernel
from repro_torch.kernels.triangle_count import kernel as tk


def dense_support(A: torch.Tensor, *, kernel: str = "auto",
                  symmetric: bool = False) -> torch.Tensor:
    """Per-edge support matrix (n, n) int32 of a dense 0/1 adjacency: the
    CUDA kernel on a CUDA tensor, the plain version on a CPU tensor.
    ``symmetric=True`` promises A == A^T (no transposed copy on the card)."""
    check_kernel(kernel)
    return tk.triangle_count(A, symmetric=symmetric)


def adjacency_from_edges(n: int, edges: np.ndarray, *,
                         device=None) -> torch.Tensor:
    """(n, n) uint8 symmetric 0/1 adjacency on ``device``."""
    dev = resolve_device(device)
    A = torch.zeros((n, n), dtype=torch.uint8, device=dev)
    if len(edges):
        e = torch.as_tensor(np.asarray(edges, np.int64), device=dev)
        A[e[:, 0], e[:, 1]] = 1
        A[e[:, 1], e[:, 0]] = 1
    return A


def dense_edge_support(n: int, edges: np.ndarray, *, kernel: str = "auto",
                       device=None) -> np.ndarray:
    """sup(e) per edge of a dense core via the dense-support kernel;
    (m,) int64 on the host."""
    A = adjacency_from_edges(n, edges, device=device)
    S = dense_support(A, kernel=kernel, symmetric=True)
    e = torch.as_tensor(np.asarray(edges, np.int64), device=A.device)
    return S[e[:, 0], e[:, 1]].to(torch.int64).cpu().numpy()
