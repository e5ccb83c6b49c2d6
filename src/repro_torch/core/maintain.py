"""Incremental truss maintenance for evolving graphs (port of
``repro.core.maintain``).

A single edge edit changes any trussness by at most 1, and only inside a
triangle-connected region around the edited edge (Zhou et al., "Efficient
Truss Maintenance in Evolving Networks", arXiv 1402.2807).
:func:`truss_maintain` applies a batch of edits one at a time, grows each
edit's affected region on the host, and re-peels only that region with
``peel.local_threshold_peel``, the single-level peel of the out-of-core
drivers, which runs the fused round kernel (B1) on the card.  Edits are
applied one by one because the +-1 bound holds per edit, not per batch.

* **Deletion** of ``e0``: each destroyed triangle ``(e0, f, f')`` seeds
  ``f`` at level ``k = phi(f)`` when ``min(phi(e0), phi(f')) >= k``.  Per
  level k >= 3 the candidates are the triangle-connected closure of the
  seeds over phi = k edges, through triangles whose other two edges have
  phi >= k; partners above k are frozen (a delete lowers them at most to
  k).  The peel at threshold k - 3 demotes exactly the candidates that lose
  their level: phi' = k - 1.
* **Insertion** of ``e0``: phi'(e0) is at most the largest k with at least
  k - 2 triangles of e0 whose partners have phi >= k - 1.  Per level k in
  3..k2 the candidates are e0 and the closure of phi = k - 1 edges reachable
  from e0 through triangles whose partners have phi >= k - 1 (e0 counts at
  every level); partners with phi >= k are frozen.  Candidates that survive
  the k - 3 peel are promoted to k; phi'(e0) is the largest level it
  survived (at least 2).

The host work of an edit is the id splice (``Graph.add_edges`` /
``remove_edges``, O(m)) and the region growth: one sorted intersection of
two neighbour lists per candidate edge.  The undirected adjacency the
growth reads carries edge ids and is updated in place of a rebuild at each
edit (two entries in or out, ids shifted), so an edit costs no sort of the
graph.  phi and the qualification values stay host int64; only a region's
local supports and triangle rows are uploaded.

Each committed edit journals ``(edges, phi)`` under the ``"maint"`` stage of
a ``bottom_up.RoundJournal``, and ``resume=True`` replays only the edits
after the newest snapshot.  The ``"maintain"`` fault site fires before each
edit.
"""

from __future__ import annotations

import dataclasses
import hashlib
from typing import Iterable, Optional, Sequence, Tuple, Union

import numpy as np

from repro_torch.core import faults
from repro_torch.core.bottom_up import OocStats, RoundJournal, _run_key
from repro_torch.core.graph import Graph, build_graph, edge_id_lookup
from repro_torch.core.peel import local_threshold_peel, reject_unported
from repro_torch.device import resolve_device
from repro_torch.kernels import check_kernel

# a qualification value above any real trussness (m bounds phi); host only
_PHI_INF = np.int64(1) << 40


@dataclasses.dataclass(frozen=True)
class EditBatch:
    """One batch of edge edits, (k, 2) vertex-pair lists; deletions apply
    before insertions.  The order does not change the final phi (every edit
    is exact), but deleting first keeps the working graph smallest."""

    inserts: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))
    deletes: np.ndarray = dataclasses.field(
        default_factory=lambda: np.zeros((0, 2), np.int64))


@dataclasses.dataclass
class MaintainResult:
    graph: Graph             # the maintained graph (edits applied)
    phi: np.ndarray          # trussness per edge of ``graph.edges``
    stats: OocStats


def _normalize_edits(edits) -> list:
    """Flatten ``edits`` to an ordered ``[(op, u, v), ...]``: an
    :class:`EditBatch` (deletes first) or a sequence of ``(op, u, v)`` with
    op "insert" or "delete"."""
    steps = []
    if isinstance(edits, EditBatch):
        for u, v in np.asarray(edits.deletes, np.int64).reshape(-1, 2):
            steps.append(("delete", int(u), int(v)))
        for u, v in np.asarray(edits.inserts, np.int64).reshape(-1, 2):
            steps.append(("insert", int(u), int(v)))
        return steps
    for step in edits:
        op, u, v = step
        if op not in ("insert", "delete"):
            raise ValueError(
                f"edit op must be 'insert' or 'delete', got {op!r}")
        steps.append((op, int(u), int(v)))
    return steps


def _edits_digest(steps: Sequence[Tuple[str, int, int]]) -> str:
    """The edit list's part of the journal's run key (the reference's)."""
    h = hashlib.sha256()
    for op, u, v in steps:
        h.update(f"{op}:{u}:{v};".encode())
    return h.hexdigest()[:16]


@dataclasses.dataclass
class _Adjacency:
    """Undirected CSR with the edge id of every entry; the order within a
    row is unspecified (every reader sorts)."""

    indptr: np.ndarray   # (n + 1,) int64
    nbrs: np.ndarray     # (2m,) neighbour vertex
    eids: np.ndarray     # (2m,) int64 edge id of the entry

    @classmethod
    def of(cls, g: Graph) -> "_Adjacency":
        e = g.edges.astype(np.int64)
        rows = np.concatenate([e[:, 0], e[:, 1]])
        order = np.argsort(rows, kind="stable")
        ids = np.arange(g.m, dtype=np.int64)
        indptr = np.zeros(g.n + 1, dtype=np.int64)
        indptr[1:] = np.cumsum(np.bincount(rows, minlength=g.n))
        return cls(indptr, np.concatenate([e[:, 1], e[:, 0]])[order],
                   np.concatenate([ids, ids])[order])

    def without(self, e0: int, a: int, b: int) -> "_Adjacency":
        """The adjacency after deleting edge e0 = (a, b); ids above e0
        move down by one."""
        keep = self.eids != e0
        eids = self.eids[keep]
        indptr = self.indptr.copy()
        indptr[a + 1:] -= 1
        indptr[b + 1:] -= 1
        return _Adjacency(indptr, self.nbrs[keep], eids - (eids > e0))

    def plus(self, e0: int, a: int, b: int) -> "_Adjacency":
        """The adjacency after inserting edge (a, b), a < b, with id e0;
        ids from e0 up move up by one.  The entries go at the rows' ends."""
        at = [self.indptr[a + 1], self.indptr[b + 1]]
        indptr = self.indptr.copy()
        indptr[a + 1:] += 1
        indptr[b + 1:] += 1
        eids = self.eids + (self.eids >= e0)
        return _Adjacency(indptr, np.insert(self.nbrs, at, [b, a]),
                          np.insert(eids, at, [e0, e0]))


def _tri_partners(g: Graph, adj: _Adjacency,
                  eid: int) -> Tuple[np.ndarray, np.ndarray]:
    """Edge ids ``(e_aw, e_bw)`` of the two partner edges of every triangle
    on edge ``eid``, in ascending order of the third vertex w (one sorted
    intersection of the endpoints' neighbour lists)."""
    a, b = (int(x) for x in g.edges[eid])
    lo_a, hi_a = adj.indptr[a], adj.indptr[a + 1]
    lo_b, hi_b = adj.indptr[b], adj.indptr[b + 1]
    _, ia, ib = np.intersect1d(adj.nbrs[lo_a:hi_a], adj.nbrs[lo_b:hi_b],
                               assume_unique=True, return_indices=True)
    return adj.eids[lo_a:hi_a][ia], adj.eids[lo_b:hi_b][ib]


def _grow_region(g: Graph, adj: _Adjacency, phi_q: np.ndarray, q: int,
                 cand_mask: np.ndarray, seeds: Iterable[int]):
    """Triangle-connected closure of candidate edges from ``seeds``.

    A triangle ``(e, a, b)`` of a candidate ``e`` qualifies when both
    partners have ``phi_q >= q``; qualifying partners in ``cand_mask`` join
    the closure, the others are frozen (the peel counts them but never
    removes them).  Returns ``(cand_ids, frozen_ids, tris)``: ascending id
    arrays, and the set of sorted edge-id triples of every qualifying
    triangle of every candidate, each once.
    """
    in_c = np.zeros(g.m, dtype=bool)
    stack = []
    for s in seeds:
        s = int(s)
        if cand_mask[s] and not in_c[s]:
            in_c[s] = True
            stack.append(s)
    frozen = set()
    tris = set()
    while stack:
        e = stack.pop()
        ea, eb = _tri_partners(g, adj, e)
        if not len(ea):
            continue
        qual = (phi_q[ea] >= q) & (phi_q[eb] >= q)
        for a, b in zip(ea[qual].tolist(), eb[qual].tolist()):
            tris.add(tuple(sorted((e, a, b))))
            for p in (a, b):
                if cand_mask[p]:
                    if not in_c[p]:
                        in_c[p] = True
                        stack.append(p)
                else:
                    frozen.add(p)
    cand_ids = np.nonzero(in_c)[0].astype(np.int64)
    frozen_ids = np.fromiter(sorted(frozen), np.int64, len(frozen))
    return cand_ids, frozen_ids, tris


def _peel_region(cand_ids: np.ndarray, frozen_ids: np.ndarray, tris,
                 thresh: int, peel_kwargs: dict,
                 fault_ctx: Optional[dict]) -> np.ndarray:
    """Peel one level's region at ``thresh``; returns the candidate ids
    removed (deletion: demoted; insertion: not promoted).  The rows are
    uploaded in sorted order, so B1's rows and the supports are the same
    from run to run."""
    lids = np.concatenate([cand_ids, frozen_ids])
    loc = np.zeros(int(lids.max()) + 1 if len(lids) else 1, np.int64)
    loc[lids] = np.arange(len(lids), dtype=np.int64)
    if tris:
        tris_local = loc[np.asarray(sorted(tris), np.int64)].astype(np.int32)
    else:
        tris_local = np.zeros((0, 3), np.int32)
    sup = np.bincount(tris_local.reshape(-1),
                      minlength=len(lids)).astype(np.int64)
    removable = np.zeros(len(lids), dtype=bool)
    removable[:len(cand_ids)] = True
    _, removed, _ = local_threshold_peel(
        sup, tris_local, removable, thresh, fault_ctx=fault_ctx,
        **peel_kwargs)
    return cand_ids[removed[:len(cand_ids)]]


def _level_ctx(edit_idx: int, k: int) -> dict:
    return {"stage": "maint", "edit": edit_idx, "k": int(k), "retry": 0}


def _apply_delete(g: Graph, adj: _Adjacency, phi: np.ndarray, u: int,
                  v: int, peel_kwargs: dict, stats: OocStats,
                  edit_idx: int):
    """One exact single-edge deletion: ``(graph', adj', phi', applied)``."""
    e0 = int(edge_id_lookup(g, np.asarray([u], np.int64),
                            np.asarray([v], np.int64))[0])
    if e0 < 0:
        return g, adj, phi, False          # absent edge: a no-op
    ea, eb = _tri_partners(g, adj, e0)     # the destroyed triangles
    k0 = int(phi[e0])
    seeds: dict = {}
    for f, other in ((ea, eb), (eb, ea)):
        if not len(f):
            continue
        kf = phi[f]
        hit = (np.minimum(k0, phi[other]) >= kf) & (kf >= 3)
        for i in np.nonzero(hit)[0]:
            seeds.setdefault(int(kf[i]), set()).add(int(f[i]))
    rm = np.zeros(g.m, dtype=bool)
    rm[e0] = True
    a, b = (int(x) for x in g.edges[e0])
    g1 = g.remove_edges(rm)
    adj1 = adj.without(e0, a, b)
    new_id = np.cumsum(~rm) - 1            # old -> new ids (survivors)
    phi_old = phi[~rm]                     # every level reads phi before
    phi_new = phi_old.copy()
    for k in sorted(seeds):
        sd = [int(new_id[e]) for e in seeds[k]]
        cand, frozen, tris = _grow_region(g1, adj1, phi_old, k,
                                          phi_old == k, sd)
        if not len(cand):
            continue
        demoted = _peel_region(cand, frozen, tris, k - 3, peel_kwargs,
                               _level_ctx(edit_idx, k))
        phi_new[demoted] = k - 1
        stats.maintain_levels += 1
        stats.affected_edges += int(len(cand))
    return g1, adj1, phi_new, True


def _apply_insert(g: Graph, adj: _Adjacency, phi: np.ndarray, u: int,
                  v: int, peel_kwargs: dict, stats: OocStats,
                  edit_idx: int):
    """One exact single-edge insertion: ``(graph', adj', phi', applied)``."""
    g1 = g.add_edges(np.asarray([[u, v]], np.int64))
    if g1 is g:
        return g, adj, phi, False          # present, or a self loop
    e0 = int(edge_id_lookup(g1, np.asarray([u], np.int64),
                            np.asarray([v], np.int64))[0])
    adj1 = adj.plus(e0, min(u, v), max(u, v))
    phi_old = np.insert(phi, e0, 2)        # e0 takes its canonical id
    phi_new = phi_old.copy()
    phi_q = phi_old.copy()
    phi_q[e0] = _PHI_INF                   # e0 qualifies at every level
    ea, eb = _tri_partners(g1, adj1, e0)   # the created triangles
    phi_e0 = 2
    if len(ea):
        tmin = np.sort(np.minimum(phi_old[ea], phi_old[eb]))[::-1]
        # k2: the largest k with >= k - 2 triangles allowing level k
        k2 = 2
        for j in range(len(tmin)):         # j + 1 triangles reach tmin[j]
            k2 = max(k2, min(int(tmin[j]) + 1, j + 3))
        for k in range(3, k2 + 1):
            cand_mask = phi_old == k - 1
            cand_mask[e0] = True
            cand, frozen, tris = _grow_region(g1, adj1, phi_q, k - 1,
                                              cand_mask, [e0])
            not_promoted = _peel_region(cand, frozen, tris, k - 3,
                                        peel_kwargs, _level_ctx(edit_idx, k))
            keep = np.ones(len(cand), dtype=bool)   # cand is ascending
            keep[np.searchsorted(cand, not_promoted)] = False
            promoted = cand[keep]
            if e0 in promoted:
                phi_e0 = max(phi_e0, k)
            phi_new[promoted[promoted != e0]] = k
            stats.maintain_levels += 1
            stats.affected_edges += int(len(cand))
    phi_new[e0] = phi_e0
    return g1, adj1, phi_new, True


def truss_maintain(graph: Union[Graph, Tuple[int, np.ndarray]],
                   phi: np.ndarray, edits, *, kernel: str = "auto",
                   mesh=None, mesh_axis="data", store=None,
                   checkpoint_dir: Optional[str] = None,
                   checkpoint_every: Union[int, str] = 1,
                   resume: bool = False, device=None) -> MaintainResult:
    """Maintain a truss decomposition under a batch of edge edits.

    ``graph`` is the current :class:`Graph` or an ``(n, edges)`` pair and
    ``phi`` its trussness per canonical edge.  ``edits`` is an
    :class:`EditBatch` or an ordered sequence of ``(op, u, v)``; no-op
    edits (deleting an absent edge, inserting a present one or a self
    loop) are skipped.  Every region peel runs through
    ``peel.local_threshold_peel`` on ``device`` (None: the CUDA card).

    ``store`` (a ``core.store`` graph store; a graph that has one keeps it)
    spills the working graph between edits: each successor is spilled
    chunk-wise before its predecessor is released, and the caller's graph
    is never released.  ``checkpoint_dir`` journals ``(edges, phi)`` after
    every ``checkpoint_every``-th edit; ``resume=True`` rebuilds the graph
    from the newest snapshot and replays only the edits after it, and
    refuses a journal of another stage.  ``mesh`` raises
    ``NotImplementedError`` (ROADMAP A13); ``mesh_axis`` goes with it.

    The result's phi equals a full decomposition of ``result.graph.edges``.
    """
    reject_unported(mesh=mesh)
    check_kernel(kernel)
    dev = resolve_device(device)
    if isinstance(graph, Graph):
        g = graph
        if store is None:
            store = g.store
    else:
        n0, edges0 = graph
        g = build_graph(int(n0), np.asarray(edges0), store=store)
    if store is not None and g.store is None:
        g = build_graph(g.n, g.edges, store=store)
    phi = np.asarray(phi, dtype=np.int64).copy()
    if len(phi) != g.m:
        raise ValueError(
            f"phi has {len(phi)} entries but the graph has {g.m} edges")
    steps = _normalize_edits(edits)
    stats = OocStats()
    peel_kwargs = dict(shape_cache=set(), kernel=kernel, device=dev)

    journal = None
    start = 0
    if checkpoint_dir is not None:
        run_key = _run_key("maintain", g.n, g.edges, budget=0,
                           partitioner="none", partitioner_seed=0,
                           edits=_edits_digest(steps))
        journal = RoundJournal(checkpoint_dir, run_key,
                               every=checkpoint_every, store=store)
        snap = journal.load_latest() if resume else None
        if snap is not None:
            tree, meta = snap
            if meta.get("stage") != "maint":
                raise ValueError(
                    f"checkpoint_dir {checkpoint_dir!r} holds a "
                    f"{meta.get('stage')!r} journal, not a maintenance "
                    f"one; refusing to resume")
            released = g
            g = build_graph(g.n, np.asarray(tree["edges"], np.int64),
                            store=store)
            if store is not None and released.store is store:
                released.unload()      # the journaled graph supersedes it
            phi = np.asarray(tree["phi"], np.int64)
            start = int(meta["index"]) + 1
            stats = OocStats.from_dict(meta.get("stats", {}))
            stats.resumed_round = int(meta["index"])

    first = g   # the caller's graph: never released here
    adj = _Adjacency.of(g) if start < len(steps) else None
    if store is not None:
        g.spill()
    for i in range(start, len(steps)):
        op, u, v = steps[i]
        faults.check(faults.MAINTAIN, edit=i, op=op, u=int(u), v=int(v))
        prev = g
        apply = _apply_delete if op == "delete" else _apply_insert
        g, adj, phi, applied = apply(g, adj, phi, u, v, peel_kwargs, stats,
                                     i)
        if applied:
            stats.edits_applied += 1
            stats.rounds += 1
            if store is not None:
                g.spill()                  # the successor first: its plan
                if prev is not first:      # aliases prev's chunks
                    prev.release()
        if journal is not None:
            journal.record("maint", i, {"phi": phi, "edges": g.edges},
                           stats)
    if store is not None:
        store.absorb_into(stats)
    return MaintainResult(graph=g, phi=phi, stats=stats)
