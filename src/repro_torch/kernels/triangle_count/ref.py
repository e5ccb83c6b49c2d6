"""Plain PyTorch version of the dense triangle-count kernel.

S = (A @ A) o A over a dense 0/1 adjacency: S[u, v] is the number of common
neighbours of u and v where (u, v) is an edge, else 0 — sup(e) for every
edge.  Computed in float32, which is exact while n < 2^24.
"""

from __future__ import annotations

import torch


def support_dense(A: torch.Tensor) -> torch.Tensor:
    """A: (n, n) 0/1, symmetric, zero diagonal.  Returns (n, n) int32."""
    Af = A.to(torch.float32)
    return ((Af @ Af) * Af).to(torch.int32)


def triangle_total(S: torch.Tensor) -> torch.Tensor:
    """Total triangle count of a support matrix: each triangle fills 6
    ordered edge slots.  A float64 0-dim tensor (exact while 6T < 2^53)."""
    return S.sum(dtype=torch.float64) / 6.0


def edge_support(S: torch.Tensor, edges: torch.Tensor) -> torch.Tensor:
    """Per-edge support gathered from a support matrix: S[u, v] for each
    row (u, v) of ``edges`` (E, 2)."""
    edges = edges.long()
    return S[edges[:, 0], edges[:, 1]]
