"""Edge-support (per-edge triangle count) computation.

The port of ``repro.core.support``.  The vectorized form keeps the paper's
O(m^1.5) bound (Theorem 1): every edge is oriented low-rank -> high-rank,
and for each oriented edge (a->b) every out-neighbour w of a is looked up in
the sorted CSR row of b by binary search; a hit is triangle {a, b, w},
found exactly once, crediting all three edge ids.

* ``edge_support_np`` / ``list_triangles_np`` / ``list_triangles`` — host
  numpy (triangle listing for the peel engines, and the oracle);
* ``edge_support`` — the skew-aware bucketed wedge scan as torch on a
  device: oriented edges grouped by the pow2 out-degree of their source
  row, each bucket scanned in chunks of (C, D) wedge candidates, counts
  scattered with ``index_add_`` into an (m + 1) int32 buffer whose last
  slot absorbs the masked candidates;
* ``edge_support_auto`` — dense cores to the dense-support kernel
  (``kernels.triangle_count``), sparse graphs to the wedge scan.

``triangle_incidence_np`` builds the edge -> triangle incidence CSR of the
frontier peel engine (``core.peel``); ``spill_triangles`` and its siblings
keep a triangle list in a graph store (``core.store``).
"""

from __future__ import annotations

import dataclasses
import math

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.device import resolve_device


def _search_iters(max_row: int) -> int:
    return max(1, math.ceil(math.log2(max_row + 1))) if max_row > 0 else 1


def _pow2_ceil(x: int) -> int:
    return 1 << max(0, math.ceil(math.log2(max(1, x))))


def _pow4_ceil(x: int) -> int:
    """Next power of four — the coarse padding grid of the batch engine."""
    return 1 << (2 * max(0, math.ceil(math.log2(max(1, x)) / 2)))


# ---------------------------------------------------------------------------
# numpy path
# ---------------------------------------------------------------------------

def _row_lower_bound_np(nbrs, lo, hi, target, iters):
    lo = lo.astype(np.int64).copy()
    hi = hi.astype(np.int64).copy()
    last = max(len(nbrs) - 1, 0)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        less = np.where(lo < hi, nbrs[np.minimum(mid, last)] < target, False)
        lo, hi = (np.where(less, mid + 1, lo),
                  np.where(less, hi, np.where(lo < hi, mid, hi)))
    return lo


def _wedge_hits_ids_np(g: Graph, eids: np.ndarray, D: int):
    """Wedge enumeration for an edge-id set with wedge width ``D`` (which
    must cover the out-degree of every source row of ``eids``).  Returns
    the (e_ab, e_aw, e_bw) edge ids of every triangle found, plus the flat
    hit mask."""
    a = g.src[eids].astype(np.int64)
    b = g.dst[eids].astype(np.int64)
    C = len(a)
    if C == 0 or D == 0:
        z = np.zeros(0, np.int64)
        return z, z, z, np.zeros(0, bool)
    last = max(len(g.nbrs) - 1, 0)
    slot = np.arange(D, dtype=np.int64)[None, :]
    row_start = g.indptr[a].astype(np.int64)[:, None]
    row_len = (g.indptr[a + 1] - g.indptr[a]).astype(np.int64)[:, None]
    valid = slot < row_len
    pos_aw = np.minimum(row_start + slot, last)
    w = g.nbrs[pos_aw].astype(np.int64)
    lo = np.broadcast_to(g.indptr[b].astype(np.int64)[:, None], (C, D))
    hi = np.broadcast_to(g.indptr[b + 1].astype(np.int64)[:, None], (C, D))
    p = _row_lower_bound_np(g.nbrs, lo.reshape(-1), hi.reshape(-1),
                            w.reshape(-1), _search_iters(g.max_out_deg))
    p = p.reshape(C, D)
    in_row = p < g.indptr[b + 1].astype(np.int64)[:, None]
    pc = np.minimum(p, last)
    hit = valid & in_row & (g.nbrs[pc] == w)
    eid = np.broadcast_to(eids[:, None], (C, D))
    e_aw = g.nbr_eid[pos_aw].astype(np.int64)
    e_bw = g.nbr_eid[pc].astype(np.int64)
    f = hit.reshape(-1)
    return eid.reshape(-1)[f], e_aw.reshape(-1)[f], e_bw.reshape(-1)[f], f


def _chunk_ids(m: int, e_lo: int, chunk: int) -> np.ndarray:
    return np.arange(e_lo, min(e_lo + chunk, m), dtype=np.int64)


def edge_support_np(g: Graph, chunk: int = 1 << 16) -> np.ndarray:
    """Support of every canonical edge (numpy, chunked)."""
    sup = np.zeros(g.m, dtype=np.int64)
    for e_lo in range(0, g.m, chunk):
        e_ab, e_aw, e_bw, _ = _wedge_hits_ids_np(
            g, _chunk_ids(g.m, e_lo, chunk), g.max_out_deg)
        for e in (e_ab, e_aw, e_bw):
            np.add.at(sup, e, 1)
    return sup


def list_triangles_np(g: Graph, chunk: int = 1 << 16) -> np.ndarray:
    """Static triangle list: (T, 3) int32 edge-id triples, each once."""
    out = []
    for e_lo in range(0, g.m, chunk):
        e_ab, e_aw, e_bw, _ = _wedge_hits_ids_np(
            g, _chunk_ids(g.m, e_lo, chunk), g.max_out_deg)
        out.append(np.stack([e_ab, e_aw, e_bw], axis=1))
    if not out:
        return np.zeros((0, 3), np.int32)
    return np.concatenate(out, axis=0).astype(np.int32)


@dataclasses.dataclass(frozen=True)
class WedgeBucket:
    """One power-of-two out-degree class of oriented edges."""

    eids: np.ndarray      # (E_pad,) edge ids, padded with m sentinels
    n_real: int           # real (unpadded) edge count
    D: int                # wedge-slot bound for this bucket (pow2)
    chunk: int            # scan chunk size

    @property
    def capacity(self) -> int:
        """Wedge elements this bucket materialises in all: its padded edges
        times D (``edge_support`` scans them ``chunk`` edges at a time)."""
        return len(self.eids) * self.D


def wedge_bucket_plan(g: Graph, chunk: int = 1 << 14,
                      budget: int = 1 << 18) -> list[WedgeBucket]:
    """Group oriented edges by the pow2 out-degree of their source row;
    ``budget`` bounds chunk * D elements per scan step."""
    if g.m == 0:
        return []
    row_len = (g.indptr[g.src + 1] - g.indptr[g.src]).astype(np.int64)
    b_idx = np.zeros(g.m, dtype=np.int64)
    nz = row_len > 1
    b_idx[nz] = np.ceil(np.log2(row_len[nz])).astype(np.int64)
    plan: list[WedgeBucket] = []
    for b in np.unique(b_idx):
        ids = np.nonzero(b_idx == b)[0].astype(np.int32)
        D = 1 << int(b)
        c = max(1, min(chunk, budget // D, _pow2_ceil(len(ids))))
        e_pad = -(-len(ids) // c) * c
        ids_pad = np.full(e_pad, g.m, np.int32)
        ids_pad[: len(ids)] = ids
        plan.append(WedgeBucket(eids=ids_pad, n_real=len(ids), D=D, chunk=c))
    return plan


def list_triangles(g: Graph, chunk: int = 1 << 14,
                   budget: int = 1 << 18) -> np.ndarray:
    """Skew-aware triangle listing: each bucket of ``wedge_bucket_plan``
    enumerates with its own D.  Same triangles as ``list_triangles_np``,
    different row order."""
    out = []
    for bucket in wedge_bucket_plan(g, chunk, budget):
        ids = bucket.eids[: bucket.n_real].astype(np.int64)
        for lo in range(0, len(ids), bucket.chunk):
            e_ab, e_aw, e_bw, _ = _wedge_hits_ids_np(
                g, ids[lo: lo + bucket.chunk], bucket.D)
            if len(e_ab):
                out.append(np.stack([e_ab, e_aw, e_bw], axis=1))
    if not out:
        return np.zeros((0, 3), np.int32)
    return np.concatenate(out, axis=0).astype(np.int32)


def support_from_triangle_list(tris: np.ndarray, m: int) -> np.ndarray:
    """sup(e) from a static triangle list (all edges alive); ids >= m
    (the drop slot) are ignored."""
    sup = np.zeros(m, dtype=np.int64)
    if len(tris):
        flat = np.asarray(tris).reshape(-1)
        counts = np.bincount(flat[flat < m], minlength=m)
        sup[: len(counts)] += counts[:m]
    return sup


def triangle_incidence_np(tris: np.ndarray,
                          m: int) -> tuple[np.ndarray, np.ndarray]:
    """CSR from edge id to the ids of the triangles containing it:
    ``tri_ids[tri_indptr[e]:tri_indptr[e+1]]``.  Entries on the drop slot
    (id >= m) are excluded."""
    tris = np.asarray(tris)
    if len(tris) == 0 or m == 0:
        return np.zeros(m + 1, np.int32), np.zeros(0, np.int32)
    flat_e = tris.reshape(-1).astype(np.int64)
    flat_t = np.repeat(np.arange(len(tris), dtype=np.int64), 3)
    keep = flat_e < m
    flat_e, flat_t = flat_e[keep], flat_t[keep]
    order = np.argsort(flat_e, kind="stable")
    tri_ids = flat_t[order].astype(np.int32)
    indptr = np.zeros(m + 1, dtype=np.int64)
    indptr[1:] = np.cumsum(np.bincount(flat_e, minlength=m))
    return indptr.astype(np.int32), tri_ids


def triangle_density(m: int, n_tris: int) -> float:
    """Incidence entries per edge slot, 3T / E."""
    return 3.0 * n_tris / m if m > 0 else 0.0


# ---------------------------------------------------------------------------
# device path
# ---------------------------------------------------------------------------

def _row_lower_bound(nbrs, lo, hi, target, iters: int):
    """Vectorized lower bound of ``target`` in ``nbrs[lo:hi]`` (sorted
    rows): a fixed ``iters``-step binary search over device tensors."""
    last = max(nbrs.shape[0] - 1, 0)
    for _ in range(iters):
        mid = (lo + hi) >> 1
        active = lo < hi
        less = active & (nbrs[mid.clamp(max=last)] < target)
        lo, hi = (torch.where(less, mid + 1, lo),
                  torch.where(less, hi, torch.where(active, mid, hi)))
    return lo


def edge_support(g: Graph, chunk: int = 1 << 14, *, budget: int = 1 << 18,
                 device=None) -> torch.Tensor:
    """sup(e) of every edge by the bucketed wedge scan on ``device``;
    returns an (m,) int32 tensor there.  No host synchronisation."""
    dev = resolve_device(device)
    m = g.m
    if m == 0:
        return torch.zeros(0, dtype=torch.int32, device=dev)

    def put(x):
        return torch.as_tensor(np.asarray(x, np.int64), device=dev)

    zero = np.zeros(1, np.int64)
    src = put(np.concatenate([g.src, zero]))     # slot m: sentinel edge
    dst = put(np.concatenate([g.dst, zero]))
    indptr, nbrs, nbr_eid = put(g.indptr), put(g.nbrs), put(g.nbr_eid)
    last = max(m - 1, 0)
    iters = _search_iters(g.max_out_deg)
    sup = torch.zeros(m + 1, dtype=torch.int32, device=dev)
    for bucket in wedge_bucket_plan(g, chunk, budget):
        ids = put(bucket.eids)
        D, c = bucket.D, bucket.chunk
        slot = torch.arange(D, device=dev)[None, :]
        ones = torch.ones(c * D, dtype=torch.int32, device=dev)
        for lo in range(0, len(bucket.eids), c):
            eids = ids[lo: lo + c]
            a, b = src[eids], dst[eids]
            row_len = (indptr[a + 1] - indptr[a])[:, None]
            valid = (slot < row_len) & (eids < m)[:, None]
            pos_aw = (indptr[a][:, None] + slot).clamp(max=last)
            w = nbrs[pos_aw]
            hi_b = indptr[b + 1][:, None]
            p = _row_lower_bound(
                nbrs, indptr[b][:, None].expand(c, D).reshape(-1),
                hi_b.expand(c, D).reshape(-1), w.reshape(-1), iters)
            p = p.reshape(c, D)
            pc = p.clamp(max=last)
            hit = valid & (p < hi_b) & (nbrs[pc] == w)
            for e in (eids[:, None].expand(c, D), nbr_eid[pos_aw],
                      nbr_eid[pc]):
                sup.index_add_(0, torch.where(hit, e, m).reshape(-1), ones)
    return sup[:m]


# ---------------------------------------------------------------------------
# dense/sparse dispatch
# ---------------------------------------------------------------------------

def dense_core_stats(g: Graph) -> tuple[np.ndarray, float]:
    """(sorted active vertices, edge density over active vertices)."""
    if g.m == 0:
        return np.zeros(0, np.int64), 0.0
    verts = np.unique(g.edges.reshape(-1)).astype(np.int64)
    n_act = len(verts)
    density = 2.0 * g.m / (n_act * (n_act - 1)) if n_act > 1 else 0.0
    return verts, density


def edge_support_auto(g: Graph, *, dense_threshold: float = 0.125,
                      dense_max_n: int = 4096, device=None) -> np.ndarray:
    """Support with sparse/dense routing: a dense core (at most
    ``dense_max_n`` active vertices and edge density >= ``dense_threshold``)
    goes to the dense-support kernel, anything else to the wedge scan.
    Returns (m,) int64 on the host."""
    dev = resolve_device(device)
    if g.m == 0:
        return np.zeros(0, np.int64)
    verts, density = dense_core_stats(g)
    n_act = len(verts)
    if n_act <= dense_max_n and density >= dense_threshold:
        from repro_torch.kernels.triangle_count.ops import dense_edge_support

        relabel = np.zeros(int(verts.max()) + 1, np.int64)
        relabel[verts] = np.arange(n_act)
        compact = relabel[g.edges.astype(np.int64)]
        return dense_edge_support(n_act, compact, device=dev)
    return edge_support(g, device=dev).cpu().numpy().astype(np.int64)


# ---------------------------------------------------------------------------
# triangle lists in a graph store: the out-of-core rounds keep the
# incremental triangle list off the host between rounds
# ---------------------------------------------------------------------------

def spill_triangles(store, key: str, tris: np.ndarray) -> None:
    """Put a round's triangle list (edge-id triples) under ``key`` as
    (T, 3) int64, replacing what the key held."""
    store.put(key, np.ascontiguousarray(tris, dtype=np.int64).reshape(-1, 3))


def load_triangles(store, key: str) -> np.ndarray:
    """A list put by :func:`spill_triangles`, whole."""
    return np.asarray(store.get(key), dtype=np.int64).reshape(-1, 3)


def iter_triangle_chunks(store, key: str):
    """A spilled list as (rows, 3) int64 blocks of the store's chunk size,
    so a consumer holds one chunk at a time instead of the list."""
    for part in store.get_chunks(key):
        yield np.asarray(part, dtype=np.int64).reshape(-1, 3)


def stream_spill_triangles(store, key: str):
    """An appendable (rows, 3) triangle writer that registers ``key`` at
    ``close()``; a chunked store writes full chunks as they fill."""
    return store.stream_put(key, np.int64, (3,))
