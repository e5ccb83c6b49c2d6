"""Graph representation for truss decomposition (host numpy).

The port's copy of ``repro.core.graph``:

* canonical edge list ``edges`` — (m, 2) int32, ``u < v``, lex-sorted,
  deduplicated, self-loop free; the row index of an edge is its edge id;
* degree-ordered orientation: vertices ranked by ``(deg, id)``, every edge
  oriented from its lower-rank endpoint, so out-degrees are O(sqrt(m)) and
  wedge enumeration costs O(m^1.5) in total;
* CSR of the oriented out-neighbourhoods with rows sorted by neighbour id,
  so membership tests are binary searches;
* optionally, the arrays kept in a graph store (``core.store``) and
  reloaded on access, so the out-of-core rounds need not hold them.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np

Int = np.int32


def canonical_edges(edges: np.ndarray, n: Optional[int] = None) -> np.ndarray:
    """Canonicalize an edge list: undirected, simple, u < v, lex-sorted.

    Negative ids raise; with an explicit ``n`` any id >= n raises, because
    the ``u * n + v`` dedup key is injective only for ids in [0, n).
    """
    edges = np.asarray(edges, dtype=np.int64).reshape(-1, 2)
    if edges.size == 0:
        return np.zeros((0, 2), dtype=Int)
    if int(edges.min()) < 0:
        raise ValueError(
            f"edge list contains negative vertex id {int(edges.min())}")
    u = np.minimum(edges[:, 0], edges[:, 1])
    v = np.maximum(edges[:, 0], edges[:, 1])
    keep = u != v
    u, v = u[keep], v[keep]
    if n is None:
        n = int(v.max()) + 1 if v.size else 0
    elif v.size and int(v.max()) >= n:
        raise ValueError(
            f"edge list references vertex id {int(v.max())} but n={n}; "
            f"vertex ids must lie in [0, n)")
    key = np.unique(u * np.int64(n) + v)
    return np.stack([key // n, key % n], axis=1).astype(Int)


def degrees(n: int, edges: np.ndarray) -> np.ndarray:
    deg = np.zeros(n, dtype=Int)
    if len(edges):
        np.add.at(deg, edges[:, 0], 1)
        np.add.at(deg, edges[:, 1], 1)
    return deg


class Graph:
    """Static-shape packed graph (numpy arrays, moved to a device by the
    functions that need them).

    edges: (m, 2) canonical edge list (edge id == row index); deg: (n,)
    degrees; rank: (n,) position in (deg, id) order; src, dst: (m,)
    oriented endpoints, rank[src] < rank[dst]; indptr: (n+1,) CSR row
    pointers; nbrs: (m,) out-neighbours, each row sorted by vertex id;
    nbr_eid: (m,) edge id of each CSR entry; max_out_deg: largest oriented
    out-degree.

    With a graph store attached (``store=``, ``repro_torch.core.store``)
    the arrays are views through the store: :meth:`spill` moves them out
    and each attribute access reloads lazily with ``store.get``.  With
    ``store=None`` they are plain resident arrays and every store method
    is a no-op.
    """

    # the spillable payload, in spill order (n and max_out_deg stay)
    _ARRAYS = ("edges", "deg", "rank", "src", "dst", "indptr", "nbrs",
               "nbr_eid")

    def __init__(self, *, n: int, edges: np.ndarray, deg: np.ndarray,
                 rank: np.ndarray, src: np.ndarray, dst: np.ndarray,
                 indptr: np.ndarray, nbrs: np.ndarray, nbr_eid: np.ndarray,
                 max_out_deg: int, store=None,
                 spill_plan: Optional[Dict[str, Tuple]] = None):
        self.n = int(n)
        self.max_out_deg = int(max_out_deg)
        self._m = len(edges)
        self._store = store
        self._key: Optional[str] = None
        self._spill_plan = spill_plan
        self._spilled: set = set()
        self._arrays: Dict[str, np.ndarray] = {
            "edges": edges, "deg": deg, "rank": rank, "src": src,
            "dst": dst, "indptr": indptr, "nbrs": nbrs, "nbr_eid": nbr_eid,
        }

    def _fetch(self, name: str) -> np.ndarray:
        arr = self._arrays.get(name)
        if arr is None:
            if self._store is None or self._key is None:
                raise RuntimeError(
                    f"graph array {name!r} was dropped without a store to "
                    f"reload it from")
            arr = self._store.get(f"{self._key}/{name}")
            self._arrays[name] = arr
        return arr

    @property
    def edges(self) -> np.ndarray:
        return self._fetch("edges")

    @property
    def deg(self) -> np.ndarray:
        return self._fetch("deg")

    @property
    def rank(self) -> np.ndarray:
        return self._fetch("rank")

    @property
    def src(self) -> np.ndarray:
        return self._fetch("src")

    @property
    def dst(self) -> np.ndarray:
        return self._fetch("dst")

    @property
    def indptr(self) -> np.ndarray:
        return self._fetch("indptr")

    @property
    def nbrs(self) -> np.ndarray:
        return self._fetch("nbrs")

    @property
    def nbr_eid(self) -> np.ndarray:
        return self._fetch("nbr_eid")

    @property
    def m(self) -> int:
        return self._m

    @property
    def store(self):
        return self._store

    # -- spill lifecycle (no-ops without a store) ----------------------------
    def spill(self) -> None:
        """Move the arrays into the store and drop the host references.

        A graph made by :meth:`remove_edges` carries a spill plan: filtered
        arrays go through ``store.put_filtered`` (source chunks whose rows
        are all kept are aliased, not rewritten) and the reused ``rank``
        through ``store.alias`` (no write).  An array spilled once is never
        rewritten; a reloaded copy is just dropped.
        """
        if self._store is None:
            return
        if self._key is None:
            self._key = self._store.graph_key()
        plan = self._spill_plan or {}
        for name in self._ARRAYS:
            if name in self._spilled:
                continue
            arr = self._arrays.get(name)
            if arr is None:
                continue
            dst_key = f"{self._key}/{name}"
            step = plan.get(name)
            if step is None:
                self._store.put(dst_key, arr)
            elif step[0] == "alias":
                self._store.alias(dst_key, step[1], arr)
            else:  # ("filter", src_key, keep_mask)
                self._store.put_filtered(dst_key, step[1], step[2], arr)
            self._spilled.add(name)
        self._spill_plan = None
        self._arrays = {}

    def prefetch(self, names: Optional[Sequence[str]] = None) -> None:
        """Ask the store to warm this graph's arrays for the next round."""
        if self._store is None or self._key is None:
            return
        self._store.prefetch([f"{self._key}/{nm}"
                              for nm in (names or self._ARRAYS)
                              if nm in self._spilled])

    def unload(self) -> None:
        """Drop the reloaded host copies of spilled arrays."""
        if self._store is None:
            return
        for name in list(self._arrays):
            if name in self._spilled:
                del self._arrays[name]

    def release(self) -> None:
        """Drop this graph's keys from the store (refcounted: chunk files
        aliased by a successor graph survive)."""
        if self._store is not None and self._key is not None:
            self._store.release(self._key)
        self._arrays = {}
        self._spilled = set()
        self._key = None

    def remove_edges(self, remove_mask: np.ndarray, *,
                     detach: bool = False) -> "Graph":
        """Drop the masked edges without a rebuild.

        ``rank`` is reused (it stays a total order, so every surviving
        edge keeps its orientation) and CSR rows are filtered in place
        (each row stays sorted).  O(n + m), no sort.  Old edge id ``i``
        maps to ``cumsum(keep)[i] - 1``.

        A store-backed graph hands its successor a spill plan (which mask
        filters which array, and the ``rank`` alias), so the successor's
        :meth:`spill` rewrites only the chunks the filter touched.
        ``detach=True`` gives a plain in-memory graph instead (a transient
        graph that must not take store keys).
        """
        remove_mask = np.asarray(remove_mask, dtype=bool)
        if remove_mask.shape != (self.m,):
            raise ValueError(f"mask shape {remove_mask.shape} != ({self.m},)")
        keep = ~remove_mask
        new_edges = self.edges[keep]
        new_id = np.cumsum(keep, dtype=np.int64) - 1
        deg = self.deg.copy()
        gone = self.edges[remove_mask]
        if len(gone):
            np.subtract.at(deg, gone[:, 0], 1)
            np.subtract.at(deg, gone[:, 1], 1)
        out_deg_old = (self.indptr[1:] - self.indptr[:-1]).astype(np.int64)
        rows = np.repeat(np.arange(self.n, dtype=np.int64), out_deg_old)
        keep_entry = keep[self.nbr_eid]
        counts = np.zeros(self.n + 1, dtype=np.int64)
        if keep_entry.any():
            np.add.at(counts, rows[keep_entry] + 1, 1)
        indptr = np.cumsum(counts).astype(Int)
        out_deg = indptr[1:] - indptr[:-1]
        store = None if detach else self._store
        plan = None
        if store is not None and self._key is not None:
            # deg, indptr and nbr_eid are recomputed: plain puts
            plan = {
                "edges": ("filter", f"{self._key}/edges", keep),
                "src": ("filter", f"{self._key}/src", keep),
                "dst": ("filter", f"{self._key}/dst", keep),
                "nbrs": ("filter", f"{self._key}/nbrs", keep_entry),
                "rank": ("alias", f"{self._key}/rank"),
            }
        return Graph(
            n=self.n, edges=new_edges, deg=deg, rank=self.rank,
            src=self.src[keep], dst=self.dst[keep], indptr=indptr,
            nbrs=self.nbrs[keep_entry],
            nbr_eid=new_id[self.nbr_eid[keep_entry]].astype(Int),
            max_out_deg=int(out_deg.max()) if self.n and len(new_edges) else 0,
            store=store, spill_plan=plan,
        )


def build_graph(n: int, edges: np.ndarray, store=None) -> Graph:
    """Build the oriented CSR package from an edge list; ``store`` attaches
    a graph store (the graph stays resident until its first spill)."""
    edges = canonical_edges(edges, n)
    m = len(edges)
    deg = degrees(n, edges)
    order = np.lexsort((np.arange(n), deg))  # vertices sorted by (deg, id)
    rank = np.empty(n, dtype=Int)
    rank[order] = np.arange(n, dtype=Int)
    if m == 0:
        return Graph(
            n=n, edges=edges, deg=deg, rank=rank,
            src=np.zeros(0, Int), dst=np.zeros(0, Int),
            indptr=np.zeros(n + 1, Int), nbrs=np.zeros(0, Int),
            nbr_eid=np.zeros(0, Int), max_out_deg=0, store=store,
        )
    u, v = edges[:, 0], edges[:, 1]
    u_first = rank[u] < rank[v]
    src = np.where(u_first, u, v).astype(Int)
    dst = np.where(u_first, v, u).astype(Int)
    order = np.lexsort((dst, src))
    rows = src[order]
    nbrs = dst[order]
    nbr_eid = np.arange(m, dtype=Int)[order]
    indptr = np.zeros(n + 1, dtype=Int)
    np.add.at(indptr, rows + 1, 1)
    indptr = np.cumsum(indptr, dtype=np.int64).astype(Int)
    out_deg = indptr[1:] - indptr[:-1]
    return Graph(
        n=n, edges=edges, deg=deg, rank=rank, src=src, dst=dst,
        indptr=indptr, nbrs=nbrs, nbr_eid=nbr_eid,
        max_out_deg=int(out_deg.max()) if n else 0, store=store,
    )


def edge_id_lookup(graph: Graph, a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Edge ids for vertex pairs (a, b); -1 if absent."""
    u = np.minimum(a, b).astype(np.int64)
    v = np.maximum(a, b).astype(np.int64)
    key = u * np.int64(graph.n) + v
    ekey = (graph.edges[:, 0].astype(np.int64) * np.int64(graph.n)
            + graph.edges[:, 1])
    if len(ekey) == 0:
        return np.full(key.shape, -1, Int)
    pos = np.clip(np.searchsorted(ekey, key), 0, len(ekey) - 1)
    return np.where(ekey[pos] == key, pos, -1).astype(Int)


def undirected_csr(graph: Graph) -> tuple[np.ndarray, np.ndarray]:
    """CSR of the undirected adjacency, ``(indptr, nbrs)``: each edge gives
    two entries (the locality partitioner's growth needs both directions).
    One stable argsort on the row; the order within a row is unspecified."""
    n, m = graph.n, graph.m
    if m == 0:
        return np.zeros(n + 1, Int), np.zeros(0, Int)
    e = graph.edges
    rows = np.concatenate([e[:, 0], e[:, 1]])
    cols = np.concatenate([e[:, 1], e[:, 0]])
    cols = cols[np.argsort(rows, kind="stable")]
    indptr = np.zeros(n + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(rows, minlength=n))
    return indptr, cols.astype(Int)


def wedge_weight(deg_a: np.ndarray, deg_b: np.ndarray) -> np.ndarray:
    """Per-pair closed-wedge weight ``max(min(deg_a, deg_b) - 1, 0)``."""
    return np.maximum(np.minimum(deg_a, deg_b) - 1, 0)


def closed_wedge_estimate(graph: Graph) -> np.ndarray:
    """Per-vertex triangle-volume estimate from wedge counts, O(m):
    ``t(v) = (1/2) * sum_{u in N(v)} wedge_weight(deg u, deg v)``.  The
    partition batches record its sum next to the true triangle count."""
    if graph.m == 0:
        return np.zeros(graph.n, np.int64)
    deg = graph.deg.astype(np.int64)
    e = graph.edges.astype(np.int64)
    w = wedge_weight(deg[e[:, 0]], deg[e[:, 1]]).astype(np.float64)
    est = np.bincount(e[:, 0], weights=w, minlength=graph.n) \
        + np.bincount(e[:, 1], weights=w, minlength=graph.n)
    return est.astype(np.int64) // 2


def compact_index(sorted_ids: np.ndarray, values: np.ndarray) -> np.ndarray:
    """Position of every value in the ascending ``sorted_ids`` (each value
    must be present)."""
    return np.searchsorted(sorted_ids, values).astype(Int)


def compact_edge_list(edges: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """Relabel an edge list's vertices to dense local ids: returns
    ``(local_edges, verts)``.  The relabeling is monotone, so a canonical
    input stays canonical and every edge keeps its row index."""
    if len(edges) == 0:
        return np.zeros((0, 2), Int), np.zeros(0, Int)
    verts = np.unique(edges.reshape(-1))
    local = np.searchsorted(verts, edges)
    return local.astype(Int), verts.astype(Int)


def incident_vertices(edges: np.ndarray) -> np.ndarray:
    """Sorted unique vertices touched by an edge list."""
    if len(edges) == 0:
        return np.zeros(0, dtype=Int)
    return np.unique(edges.reshape(-1)).astype(Int)
