"""Neighbour sampler for minibatch GNN training (port of the JAX package's
``models/gnn/sampler.py``; GraphSAGE-style fanouts).

Host-side numpy, the data pipeline: fixed-shape padded subgraphs for the
device step.  Uniform sampling, or weighted sampling with per-edge weights
such as trussness (``core.sparsify.sampling_weights``: strong ties first).
The same calls on the same ``np.random.Generator`` give the reference's
arrays, draw for draw.
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Sequence

import numpy as np


@dataclasses.dataclass
class CSR:
    indptr: np.ndarray
    nbrs: np.ndarray
    edge_w: Optional[np.ndarray] = None   # per-entry sampling weight

    @staticmethod
    def from_edges(n: int, edges: np.ndarray, edge_w=None) -> "CSR":
        """Symmetric CSR from a canonical (u < v) edge list."""
        src = np.concatenate([edges[:, 0], edges[:, 1]])
        dst = np.concatenate([edges[:, 1], edges[:, 0]])
        w = None if edge_w is None else np.concatenate([edge_w, edge_w])
        order = np.argsort(src, kind="stable")
        src, dst = src[order], dst[order]
        if w is not None:
            w = w[order]
        indptr = np.zeros(n + 1, np.int64)
        np.add.at(indptr, src + 1, 1)
        return CSR(np.cumsum(indptr), dst.astype(np.int32), w)


def sample_subtree(csr: CSR, seeds: np.ndarray, fanouts: Sequence[int],
                   rng: np.random.Generator
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Fanout-sample a k-hop subtree (with replacement).

    Returns (nodes, edge_index, edge_mask): ``nodes`` is the padded flat
    node-id array (seeds first); ``edge_index`` (E, 2) joins each sampled
    neighbour to its parent (src = neighbour, dst = parent) as local
    indices into ``nodes``; a frontier node with no neighbour gives padding
    entries, node 0 with mask False.
    """
    nodes = [seeds.astype(np.int32)]
    edges, masks = [], []
    frontier = seeds.astype(np.int64)
    offset = 0
    for f in fanouts:
        deg = csr.indptr[frontier + 1] - csr.indptr[frontier]
        picks = np.zeros((len(frontier), f), np.int64)
        ok = deg > 0
        r = rng.random((len(frontier), f))
        if csr.edge_w is None:
            idx = (r * np.maximum(deg, 1)[:, None]).astype(np.int64)
            picks = csr.nbrs[csr.indptr[frontier][:, None] + idx]
        else:
            for i, v in enumerate(frontier):   # weighted: a choice a row
                s, e = csr.indptr[v], csr.indptr[v + 1]
                if e > s:
                    w = csr.edge_w[s:e].astype(np.float64)
                    w = w / w.sum()
                    picks[i] = csr.nbrs[s + rng.choice(e - s, size=f, p=w)]
        mask = np.broadcast_to(ok[:, None], (len(frontier), f)).copy()
        child_base = offset + len(frontier)
        parent_local = np.repeat(np.arange(offset, offset + len(frontier)), f)
        child_local = np.arange(child_base, child_base + frontier.size * f)
        edges.append(np.stack([child_local, parent_local], axis=1))
        masks.append(mask.reshape(-1))
        nodes.append(np.where(mask, picks, 0).astype(np.int32).reshape(-1))
        frontier = picks.reshape(-1)
        offset = child_base
    return (np.concatenate(nodes), np.concatenate(edges).astype(np.int32),
            np.concatenate(masks))


def minibatch(csr: CSR, feats: np.ndarray, labels: np.ndarray,
              batch_nodes: int, fanouts: Sequence[int],
              rng: np.random.Generator) -> dict:
    """One padded training minibatch: ``batch_nodes`` random seeds (the
    labelled rows) and their sampled subtree, as host arrays."""
    n = len(feats)
    seeds = rng.integers(0, n, size=batch_nodes)
    nodes, edge_index, edge_mask = sample_subtree(csr, seeds, fanouts, rng)
    label_mask = np.zeros(len(nodes), np.float32)
    label_mask[:batch_nodes] = 1.0
    lab = np.zeros(len(nodes), np.int32)
    lab[:batch_nodes] = labels[seeds]
    return {
        "node_feat": feats[nodes].astype(np.float32),
        "edge_index": edge_index,
        "edge_mask": edge_mask,
        "labels": lab,
        "label_mask": label_mask,
    }
