"""Paper-faithful serial truss decomposition (numpy/python oracles).

``alg1_truss`` is Cohen's original algorithm (the paper's Algorithm 1,
"TD-inmem"): on each edge removal it intersects the full neighbourhoods of
both endpoints, O(sum_v deg(v)^2) in all.  It is the baseline that the
paper's Table 3 measures the other algorithms against, so it stays this
Python loop.

``alg2_truss`` is the paper's Algorithm 2 ("TD-inmem+"): edges kept in a
bin-sorted array by support; on removal of e = (u, v) only the neighbours of
the lower-degree endpoint are enumerated, with O(1) hash membership tests —
O(m^1.5) in all.

Both return phi per canonical edge id.  ``truss_from_phi`` extracts the
k-truss from a phi, and ``verify_truss`` checks a phi against the
definition.  They are the port's own oracles (``chip_smoke.py`` holds the
card's answer against them).
"""

from __future__ import annotations

import numpy as np

from repro_torch.core import graph as glib
from repro_torch.core.support import edge_support_np


class _EdgeBins:
    """Bin-sorted edge array with O(1) decrement (Batagelj–Zaversnik)."""

    def __init__(self, sup: np.ndarray):
        self.m = len(sup)
        self.sup = sup.astype(np.int64).copy()
        max_s = int(self.sup.max()) if self.m else 0
        self.arr = np.argsort(self.sup, kind="stable").astype(np.int64)
        self.pos = np.empty(self.m, dtype=np.int64)
        self.pos[self.arr] = np.arange(self.m)
        counts = np.bincount(self.sup, minlength=max_s + 2)
        self.bin_start = np.zeros(max_s + 2, dtype=np.int64)
        self.bin_start[1:] = np.cumsum(counts)[:-1]
        self.head = 0

    def min_support(self) -> int:
        return int(self.sup[self.arr[self.head]])

    def empty(self) -> bool:
        return self.head >= self.m

    def pop_min(self) -> int:
        e = int(self.arr[self.head])
        self.head += 1
        return e

    def decrement(self, e: int) -> None:
        """sup[e] -= 1, keeping the array bin-sorted (O(1))."""
        s = int(self.sup[e])
        p = int(self.pos[e])
        q = max(int(self.bin_start[s]), self.head)
        o = int(self.arr[q])
        self.arr[p], self.arr[q] = o, e
        self.pos[o], self.pos[e] = p, q
        self.bin_start[s] = q + 1
        self.sup[e] = s - 1


def _adjacency(n: int, edges: np.ndarray) -> list[dict[int, int]]:
    adj: list[dict[int, int]] = [dict() for _ in range(n)]
    for eid, (u, v) in enumerate(edges):
        adj[u][v] = eid
        adj[v][u] = eid
    return adj


def initial_support(n: int, edges: np.ndarray) -> np.ndarray:
    """sup(e) for every canonical edge, by degree-oriented wedge counting."""
    return edge_support_np(glib.build_graph(n, edges))


def alg2_truss(n: int, edges: np.ndarray,
               sup: np.ndarray | None = None) -> np.ndarray:
    """Paper Algorithm 2.  Returns phi per canonical edge id."""
    edges = glib.canonical_edges(edges, n)
    m = len(edges)
    phi = np.zeros(m, dtype=np.int64)
    if m == 0:
        return phi
    if sup is None:
        sup = initial_support(n, edges)
    bins = _EdgeBins(np.asarray(sup))
    adj = _adjacency(n, edges)
    removed = np.zeros(m, dtype=bool)
    k = 2
    while not bins.empty():
        if bins.min_support() > k - 2:
            k += 1
            continue
        e = bins.pop_min()
        removed[e] = True
        u, v = int(edges[e, 0]), int(edges[e, 1])
        if len(adj[u]) > len(adj[v]):
            u, v = v, u
        av = adj[v]
        for w, euw in list(adj[u].items()):
            evw = av.get(w)
            if evw is None:
                continue
            if not removed[euw]:
                bins.decrement(euw)
            if not removed[evw]:
                bins.decrement(evw)
        del adj[u][v], adj[v][u]
        phi[e] = k
    return phi


def alg1_truss(n: int, edges: np.ndarray,
               sup: np.ndarray | None = None) -> np.ndarray:
    """Paper Algorithm 1 (Cohen's "TD-inmem"): a full intersection of both
    neighbourhoods on every removal.  Returns phi per canonical edge id."""
    edges = glib.canonical_edges(edges, n)
    m = len(edges)
    phi = np.zeros(m, dtype=np.int64)
    if m == 0:
        return phi
    if sup is None:
        sup = initial_support(n, edges)
    bins = _EdgeBins(np.asarray(sup))
    adj = _adjacency(n, edges)
    removed = np.zeros(m, dtype=bool)
    # k starts at 3 and the threshold is strict (an edge goes while its
    # support is below k - 2), so an edge removed at level k survives the
    # (k-1)-truss: its phi is k - 1
    k = 3
    while not bins.empty():
        if bins.min_support() >= k - 2:
            k += 1
            continue
        e = bins.pop_min()
        removed[e] = True
        u, v = int(edges[e, 0]), int(edges[e, 1])
        # Steps 5-6: the whole intersection, no degree ordering
        for w in set(adj[u].keys()) & set(adj[v].keys()):
            euw, evw = adj[u][w], adj[v][w]
            if not removed[euw]:
                bins.decrement(euw)
            if not removed[evw]:
                bins.decrement(evw)
        del adj[u][v], adj[v][u]
        phi[e] = k - 1
    return phi


def truss_from_phi(edges: np.ndarray, phi: np.ndarray, k: int) -> np.ndarray:
    """The k-truss's edges: the union of the classes >= k (paper Section
    2).  ``edges`` are the canonical edges ``phi`` is indexed by."""
    return edges[phi >= k]


def verify_truss(n: int, edges: np.ndarray, phi: np.ndarray) -> bool:
    """Definition-level check: for each k, every edge of the k-truss has
    support >= k-2 inside the k-truss."""
    edges = glib.canonical_edges(edges, n)
    if len(edges) == 0:
        return True
    for k in range(2, int(phi.max()) + 1):
        tk = truss_from_phi(edges, phi, k)
        if len(tk) and (edge_support_np(glib.build_graph(n, tk)) < k - 2).any():
            return False
    return True
