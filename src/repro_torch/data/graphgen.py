"""Synthetic graph generators (host numpy, deterministic per seed).

* ``rmat`` — power-law R-MAT graphs (Graph500 parameters by default), the
  shape of the paper's web/social datasets;
* ``erdos_renyi`` — flat-degree control;
* ``planted_cliques`` — community graphs with known dense cores;
* ``mesh2d`` — a triangulated grid (MeshGraphNet-like geometry);
* the GNN batch builders (``gnn_full_batch``, ``gnn_molecule_batch``), which
  give the padded dict format of ``models/gnn`` as host arrays, equal to
  the JAX package's array for array.
"""

from __future__ import annotations

from typing import Optional

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


def mesh2d(rows: int, cols: int) -> tuple[int, np.ndarray, np.ndarray]:
    """Triangulated grid: returns (n, edges, positions (n, 3))."""
    n = rows * cols
    idx = np.arange(n).reshape(rows, cols)
    e = [np.stack([idx[:, :-1].ravel(), idx[:, 1:].ravel()], 1),
         np.stack([idx[:-1, :].ravel(), idx[1:, :].ravel()], 1),
         np.stack([idx[:-1, :-1].ravel(), idx[1:, 1:].ravel()], 1)]
    edges = glib.canonical_edges(np.concatenate(e), n)
    xy = np.stack(np.meshgrid(np.arange(rows), np.arange(cols), indexing="ij"),
                  -1).reshape(n, 2).astype(np.float32)
    pos = np.concatenate([xy, np.zeros((n, 1), np.float32)], 1)
    return n, edges, pos


# ---------------------------------------------------------------------------
# GNN batch builders (the static padded dict format of models/gnn)
# ---------------------------------------------------------------------------

def _directed(edges: np.ndarray) -> np.ndarray:
    return np.concatenate([edges, edges[:, ::-1]]).astype(np.int32)


def edge_features(pos: np.ndarray, ei: np.ndarray) -> np.ndarray:
    """MeshGraphNet's edge features: the relative position of each edge's
    destination from its source and its norm, (E, 4) float32."""
    rel = pos[ei[:, 1]] - pos[ei[:, 0]]
    return np.concatenate(
        [rel, np.linalg.norm(rel, axis=1, keepdims=True)], 1).astype(
            np.float32)


def gnn_full_batch(n: int, edges: np.ndarray, d_feat: int, n_classes: int,
                   seed: int = 0, positions: Optional[np.ndarray] = None,
                   regression: bool = False) -> dict:
    """A whole graph as one batch: both directions of every edge, normal
    node features and positions, node labels (half of them in the loss) or
    regression targets, and MeshGraphNet's edge features and vector
    targets."""
    rng = np.random.default_rng(seed)
    ei = _directed(edges)
    batch = {
        "node_feat": rng.standard_normal((n, d_feat)).astype(np.float32),
        "edge_index": ei,
        "edge_mask": np.ones(len(ei), bool),
        "positions": (positions if positions is not None
                      else rng.standard_normal((n, 3)).astype(np.float32)),
    }
    if regression:
        batch["targets"] = rng.standard_normal(n).astype(np.float32)
        batch["node_mask"] = np.ones(n, np.float32)
    else:
        batch["labels"] = rng.integers(0, n_classes, n).astype(np.int32)
        batch["label_mask"] = (rng.random(n) < 0.5).astype(np.float32)
    batch["edge_feat"] = edge_features(batch["positions"], ei)
    batch["targets_vec"] = rng.standard_normal((n, 3)).astype(np.float32)
    return batch


def gnn_molecule_batch(n_graphs: int, n_nodes: int, n_edges: int,
                       d_feat: int, seed: int = 0) -> dict:
    """Small graphs (Erdos-Renyi, ``n_edges`` directed edges at most each)
    flattened into one disjoint graph, with regression targets."""
    all_edges = []
    for g in range(n_graphs):
        e = erdos_renyi(n_nodes, n_edges // 2, seed + 7 * g + 1)
        all_edges.append(_directed(e) + g * n_nodes)
    ei = np.concatenate(all_edges).astype(np.int32)
    b = gnn_full_batch(n_graphs * n_nodes, np.zeros((0, 2), np.int64), d_feat,
                       2, seed, regression=True)
    b["edge_index"] = ei
    b["edge_mask"] = np.ones(len(ei), bool)
    b["edge_feat"] = edge_features(b["positions"], ei)
    return b
