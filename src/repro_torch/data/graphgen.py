"""Synthetic graph generators (host numpy, deterministic per seed).

* ``rmat`` — power-law R-MAT graphs (Graph500 parameters by default), the
  shape of the paper's web/social datasets;
* ``erdos_renyi`` — flat-degree control;
* ``planted_cliques`` — community graphs with known dense cores.
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import graph as glib


def erdos_renyi(n: int, m_target: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    m = int(m_target * 1.15) + 16
    u = rng.integers(0, n, m * 2, dtype=np.int64)
    v = rng.integers(0, n, m * 2, dtype=np.int64)
    e = glib.canonical_edges(np.stack([u, v], 1), n)
    return e[:m_target] if len(e) > m_target else e


def rmat(scale: int, edge_factor: int = 16, seed: int = 0,
         a=0.57, b=0.19, c=0.19) -> tuple[int, np.ndarray]:
    """R-MAT generator: returns ``(n, canonical edges)``."""
    rng = np.random.default_rng(seed)
    n = 1 << scale
    m = n * edge_factor
    src = np.zeros(m, np.int64)
    dst = np.zeros(m, np.int64)
    for bit in range(scale):
        r = rng.random(m)
        go_right = (r >= a) & (r < a + b) | (r >= a + b + c)
        go_down = r >= a + b
        src |= go_down.astype(np.int64) << bit
        dst |= go_right.astype(np.int64) << bit
    return n, glib.canonical_edges(np.stack([src, dst], 1), n)


def planted_cliques(n: int, n_cliques: int, clique_size: int,
                    noise_edges: int, seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    edges = []
    for _ in range(n_cliques):
        verts = rng.choice(n, clique_size, replace=False)
        iu = np.triu_indices(clique_size, 1)
        edges.append(np.stack([verts[iu[0]], verts[iu[1]]], 1))
    u = rng.integers(0, n, noise_edges)
    v = rng.integers(0, n, noise_edges)
    edges.append(np.stack([u, v], 1))
    return glib.canonical_edges(np.concatenate(edges), n)
