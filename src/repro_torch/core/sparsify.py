"""Truss-based graph utilities (port of ``repro.core.sparsify``):

* ``truss_filter``       — the edges of the k-truss;
* ``trussness_features`` — per-edge trussness normalized to [0, 1];
* ``sampling_weights``   — neighbour-sampling weights proportional to
                           (trussness - 1) ** alpha;
* ``clique_upper_bound`` — k_max, a bound on the maximum clique size.

Each decomposes through ``peel.truss_decompose`` on ``device`` (None: the
CUDA card).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import graph as glib
from repro_torch.core.peel import truss_decompose


def truss_filter(n: int, edges: np.ndarray, k: int, *,
                 device=None) -> np.ndarray:
    """Edge list of the k-truss T_k."""
    edges = glib.canonical_edges(edges, n)
    phi = truss_decompose(n, edges, device=device)
    return edges[phi >= k]


def trussness_features(n: int, edges: np.ndarray, *,
                       device=None) -> tuple[np.ndarray, np.ndarray]:
    """(canonical edges, trussness normalized to [0, 1]) per edge."""
    edges = glib.canonical_edges(edges, n)
    phi = truss_decompose(n, edges, device=device).astype(np.float32)
    kmax = max(phi.max(), 3.0)
    return edges, (phi - 2.0) / (kmax - 2.0)


def sampling_weights(n: int, edges: np.ndarray, alpha: float = 1.0, *,
                     device=None) -> np.ndarray:
    """Per-edge neighbour-sampling weight proportional to (trussness - 1)
    ** alpha, normalized to sum 1."""
    edges = glib.canonical_edges(edges, n)
    phi = truss_decompose(n, edges, device=device).astype(np.float64)
    w = np.maximum(phi - 1.0, 1.0) ** alpha
    return (w / w.sum()).astype(np.float32)


def clique_upper_bound(n: int, edges: np.ndarray, *, device=None) -> int:
    """The maximum clique has at most k_max vertices (tighter than
    c_max + 1; paper Section 7.4)."""
    phi = truss_decompose(n, edges, device=device)
    return int(phi.max()) if len(phi) else 2
