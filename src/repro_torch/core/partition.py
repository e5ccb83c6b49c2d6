"""Vertex partitioners and partition batches of the I/O-efficient drivers.

Host numpy, copied from ``repro.core.partition``.  The paper (Section 5.1)
splits the current graph into parts whose *neighbourhood subgraphs* NS(P)
fit a working-set budget, counted in edge entries:

* ``sequential_partition`` — contiguous vertex-id blocks whose summed NS
  cost (incident degrees) stays under the budget;
* ``random_partition`` — vertices hashed into ceil(total / budget) parts,
  with each overflowing part's excess repacked cost-bounded;
* ``locality_partition`` — triangle-aware growth over the undirected
  adjacency: parts grow from the vertices of largest estimated triangle
  volume and admit neighbours by closed-wedge gain, covering one zone of
  the graph per round, so that a part holds its own triangles.

:func:`build_partition_batch` turns one round's parts into the device form:
every NS(P) extracted in one sweep and compacted to local edge ids, parts
grouped into pow4 size classes, first-fit-decreasing packed into lanes and
padded to static shapes.  Padding lanes are dead and padding triangles
point at the per-lane drop slot ``cap_e``.  For a mesh dispatch
(``lane_multiple`` > 1) the packing is waste-aware instead: one capacity
class, lanes padded to the device multiple only, and a shape ladder of the
run's earlier bucket shapes.
"""

from __future__ import annotations

import dataclasses
import warnings
from typing import List, Sequence, Tuple

import numpy as np

from repro_torch.core.graph import (Graph, closed_wedge_estimate,
                                    compact_index, undirected_csr,
                                    wedge_weight)
from repro_torch.core.support import (_pow2_ceil, _pow4_ceil, list_triangles,
                                      support_from_triangle_list,
                                      triangle_incidence_np)


class PartitionBudgetWarning(UserWarning):
    """A single vertex's NS estimate exceeds the partition budget; it still
    becomes a (over-budget) singleton part."""

    def __init__(self, n_over: int, budget: int, max_cost: int):
        self.n_over = n_over
        self.budget = budget
        self.max_cost = max_cost
        super().__init__(
            f"{n_over} vertex(es) have NS cost above budget={budget} "
            f"(max cost {max_cost}); emitting over-budget singleton parts")


def _ns_cost(g: Graph) -> np.ndarray:
    """Per-vertex NS working-set estimate: its full incident degree."""
    return g.deg.astype(np.int64)


def _warn_over_budget(cost: np.ndarray, active: np.ndarray, budget: int,
                      stacklevel: int = 3) -> None:
    over = cost[active] > budget
    if over.any():
        warnings.warn(
            PartitionBudgetWarning(int(over.sum()), int(budget),
                                   int(cost[active][over].max())),
            stacklevel=stacklevel)


def _pack_cost_bounded(vertices, cost: np.ndarray,
                       budget: int) -> List[np.ndarray]:
    """Split ``vertices`` (in order) into consecutive groups whose summed
    cost stays within ``budget``; an over-budget vertex is a singleton."""
    parts: List[np.ndarray] = []
    cur: list[int] = []
    acc = 0
    for v in vertices:
        c = int(cost[v])
        if cur and acc + c > budget:
            parts.append(np.asarray(cur, dtype=np.int32))
            cur, acc = [], 0
        cur.append(int(v))
        acc += c
    if cur:
        parts.append(np.asarray(cur, dtype=np.int32))
    return parts


def round_up_to_multiple(count: int, multiple: int) -> int:
    """Smallest positive count >= ``count`` divisible by ``multiple``: the
    lane and row padding rule of the mesh dispatch (the lane packing below,
    ``distributed.pad_bucket_lanes``, the candidate peel's triangle rows)."""
    return max(1, -(-count // multiple)) * multiple


def _first_fit_decreasing(sizes: Sequence[int],
                          capacity: int) -> List[List[int]]:
    """Pack item indices into bins of ``capacity``, first-fit-decreasing
    (an item above the capacity still gets its own bin)."""
    order = sorted(range(len(sizes)), key=lambda i: -sizes[i])
    bins: List[List[int]] = []
    room: List[int] = []
    for i in order:
        s = sizes[i]
        for j in range(len(bins)):
            if room[j] >= s:
                bins[j].append(i)
                room[j] -= s
                break
        else:
            bins.append([i])
            room.append(capacity - s)
    return bins


def _first_fit_decreasing_2d(costs: Sequence[int], tris: Sequence[int],
                             cap_cost: int, cap_tri: int) -> List[List[int]]:
    """First-fit-decreasing on cost with a soft triangle dimension.

    Cost is the hard constraint and keeps the classic order and bound: a
    bin opens only when the cost fits nowhere.  Among the bins where the
    cost fits, an item goes to the first where its triangles fit too, else
    to the one with the most triangle room, so triangle-dense fragments
    spread across bins.
    """
    order = sorted(range(len(costs)), key=lambda i: (-costs[i], -tris[i]))
    bins: List[List[int]] = []
    room_c: List[int] = []
    room_t: List[int] = []
    for i in order:
        placed = -1
        for j in range(len(bins)):
            if room_c[j] >= costs[i] and room_t[j] >= tris[i]:
                placed = j
                break
        if placed < 0:
            feasible = [j for j in range(len(bins)) if room_c[j] >= costs[i]]
            if feasible:
                placed = max(feasible, key=lambda j: room_t[j])
        if placed < 0:
            bins.append([i])
            room_c.append(cap_cost - costs[i])
            room_t.append(cap_tri - tris[i])
        else:
            bins[placed].append(i)
            room_c[placed] -= costs[i]
            room_t[placed] -= tris[i]
    return bins


def sequential_partition(g: Graph, budget: int) -> List[np.ndarray]:
    """Contiguous vertex blocks with estimated NS size <= budget each."""
    cost = _ns_cost(g)
    active = np.nonzero(cost > 0)[0]
    if len(active) == 0:
        return []
    _warn_over_budget(cost, active, budget)
    return _pack_cost_bounded(active, cost, budget)


def random_partition(g: Graph, budget: int, seed: int = 0) -> List[np.ndarray]:
    """Hash vertices into ceil(total_cost / budget) parts; each overflowing
    bin keeps its largest under-budget prefix (at least one vertex) and the
    spill is repacked cost-bounded, largest first."""
    cost = _ns_cost(g)
    active = np.nonzero(cost > 0)[0]
    if len(active) == 0:
        return []
    _warn_over_budget(cost, active, budget)
    total = int(cost[active].sum())
    p = max(1, int(np.ceil(total / max(budget, 1))))
    rng = np.random.default_rng(seed)
    assign = rng.integers(0, p, size=len(active))
    parts: List[np.ndarray] = []
    spill: List[np.ndarray] = []
    for i in range(p):
        P = active[assign == i]
        if len(P) == 0:
            continue
        csum = np.cumsum(cost[P])
        k = max(int(np.searchsorted(csum, budget, side="right")), 1)
        parts.append(P[:k].astype(np.int32))
        if k < len(P):
            spill.append(P[k:])
    if spill:
        sp = np.concatenate(spill)
        sp = sp[np.argsort(-cost[sp], kind="stable")]
        parts.extend(_pack_cost_bounded(sp, cost, budget))
    return parts


# Zone of one locality round: parts grow until the covered NS cost reaches
# max(zone_mult * budget, total_cost / _ZONE_FRACTION).  The multiple
# follows the previous round's observed capture (``_zone_mult``):
# _ZONE_BUDGET_MULT on the first round, then within [_ZONE_MULT_MIN,
# _ZONE_MULT_MAX].
_ZONE_BUDGET_MULT = 4
_ZONE_FRACTION = 16
_ZONE_MULT_MIN = 2.0
_ZONE_MULT_MAX = 16.0


def _zone_mult(prev_locality: float | None) -> float:
    """Zone multiple from the previous round's ``tri_locality``: linear in
    the captured fraction between _ZONE_MULT_MIN and _ZONE_MULT_MAX (a high
    capture widens the zone, a low one shrinks it toward the budget), and
    _ZONE_BUDGET_MULT before any observation."""
    if prev_locality is None:
        return float(_ZONE_BUDGET_MULT)
    frac = min(1.0, max(0.0, float(prev_locality)))
    return _ZONE_MULT_MIN + (_ZONE_MULT_MAX - _ZONE_MULT_MIN) * frac


def locality_partition(
    g: Graph, budget: int, prev_locality: float | None = None,
) -> List[np.ndarray]:
    """Triangle-aware zoned growth over the adjacency.

    One call covers a zone of the working graph, up to
    ``max(_zone_mult(prev_locality) * budget, total_cost / 16)`` of NS
    cost, and leaves the rest to later rounds (the round loop repeats until
    no edge is left, so a partial cover is sound).  Each part grows from
    the unassigned vertex of largest estimated triangle volume
    (``closed_wedge_estimate``, NS cost breaking ties) and keeps a pool of
    the unassigned neighbours of the part so far.  When ``v`` joins, each
    neighbour ``u`` gains ``wedge_weight(deg u, deg v)``; candidates are
    ranked by that gain, then by edges into the part, then by cheap
    marginal cost ``deg(u) - edges_into_part(u)``, and the longest ranked
    prefix that fits the budget is admitted (a candidate whose marginal
    cost alone exceeds the room is skipped).  The grown fragments are then
    merged first-fit over (NS cost, triangle estimate)
    (:func:`_first_fit_decreasing_2d`, triangle capacity
    ``total_tri * budget / total_cost``).
    """
    cost = _ns_cost(g)
    active = np.nonzero(cost > 0)[0]
    if len(active) == 0:
        return []
    _warn_over_budget(cost, active, budget)
    indptr, nbrs = undirected_csr(g)
    indptr = np.asarray(indptr, dtype=np.int64)
    nbrs64 = np.asarray(nbrs, dtype=np.int64)
    deg = g.deg.astype(np.int64)
    tri_est = closed_wedge_estimate(g)
    unassigned = cost > 0
    zone_cost = max(int(_zone_mult(prev_locality) * budget),
                    int(cost[active].sum()) // _ZONE_FRACTION)
    seed_order = active[np.lexsort((-cost[active], -tri_est[active]))]
    seed_pos = 0
    # per-part candidate scores, trusted only where stamp == part id
    gain = np.zeros(g.n, dtype=np.int64)      # closed-wedge gain
    ecnt = np.zeros(g.n, dtype=np.int64)      # edges into the part
    stamp = np.full(g.n, -1, dtype=np.int64)
    parts: List[np.ndarray] = []
    part_cost: List[int] = []                 # |NS| charged per fragment
    part_tri: List[int] = []
    covered = 0
    while covered < zone_cost:
        while (seed_pos < len(seed_order)
               and not unassigned[seed_order[seed_pos]]):
            seed_pos += 1
        if seed_pos >= len(seed_order):
            break
        s = int(seed_order[seed_pos])
        part_id = len(parts)
        unassigned[s] = False
        acc = int(cost[s])
        chunks = [np.array([s], dtype=np.int64)]
        newly = chunks[0]
        pool = np.zeros(0, dtype=np.int64)
        while acc < budget:
            # score the unassigned neighbours of the vertices just admitted
            starts = indptr[newly]
            cnt = indptr[newly + 1] - starts
            tot = int(cnt.sum())
            if tot:
                flat = np.repeat(starts - (np.cumsum(cnt) - cnt), cnt) \
                    + np.arange(tot)
                cand = nbrs64[flat]
                src = np.repeat(newly, cnt)
                keep = unassigned[cand]
                cand, src = cand[keep], src[keep]
            else:
                cand = src = np.zeros(0, dtype=np.int64)
            if len(cand):
                uniq = np.unique(cand)
                stale = stamp[uniq] != part_id
                gain[uniq[stale]] = 0
                ecnt[uniq[stale]] = 0
                stamp[uniq] = part_id
                np.add.at(gain, cand, wedge_weight(deg[cand], deg[src]))
                np.add.at(ecnt, cand, 1)
                pool = np.unique(np.concatenate([pool, uniq]))
            pool = pool[unassigned[pool]]
            if len(pool) == 0:
                break
            mc = np.maximum(cost[pool] - ecnt[pool], 0)
            order = np.lexsort((mc, -ecnt[pool], -gain[pool]))
            ranked = pool[order]
            mcr = mc[order]
            fit1 = mcr <= budget - acc
            ranked, mcr = ranked[fit1], mcr[fit1]
            fits = acc + np.cumsum(mcr) <= budget
            take = ranked[fits]
            if len(take) == 0:
                break
            unassigned[take] = False
            acc += int(mcr[fits].sum())
            chunks.append(take)
            newly = take
        P = np.concatenate(chunks)
        parts.append(P.astype(np.int32))
        part_cost.append(acc)
        part_tri.append(int(tri_est[P].sum()))
        covered += acc
    if len(parts) > 1:
        total_c = sum(part_cost)
        cap_tri = max(1, -(-sum(part_tri) * budget // max(total_c, 1)))
        bins = _first_fit_decreasing_2d(part_cost, part_tri, budget, cap_tri)
        parts = [np.concatenate([parts[i] for i in b]) for b in bins]
    return parts


PARTITIONERS = {
    "sequential": sequential_partition,
    "random": random_partition,
    "locality": locality_partition,
}


# ---------------------------------------------------------------------------
# Partition batches
# ---------------------------------------------------------------------------

def ns_edge_lists(
    g: Graph, parts: Sequence[np.ndarray],
    part_of: np.ndarray | None = None,
) -> List[Tuple[np.ndarray, np.ndarray]]:
    """Every NS(P_i) edge list in one sweep: per part, ``(edge_ids,
    internal)`` with edge ids ascending.  An edge is in the NS of the
    part(s) of its endpoints and internal when both share one part."""
    if part_of is None:
        part_of = np.full(g.n, -1, dtype=np.int64)
        for i, P in enumerate(parts):
            part_of[np.asarray(P, dtype=np.int64)] = i
    e = g.edges.astype(np.int64)
    pu = part_of[e[:, 0]]
    pv = part_of[e[:, 1]]
    internal_flag = (pu == pv) & (pu >= 0)
    eids = np.arange(g.m, dtype=np.int64)
    dup = (pv != pu) & (pv >= 0)
    owner = np.concatenate([pu, pv[dup]])
    owner_e = np.concatenate([eids, eids[dup]])
    keep = owner >= 0
    owner, owner_e = owner[keep], owner_e[keep]
    order = np.lexsort((owner_e, owner))
    owner, owner_e = owner[order], owner_e[order]
    bounds = np.searchsorted(owner, np.arange(len(parts) + 1))
    out: List[Tuple[np.ndarray, np.ndarray]] = []
    for i in range(len(parts)):
        ids = owner_e[bounds[i]:bounds[i + 1]].astype(np.int32)
        out.append((ids, internal_flag[ids]))
    return out


@dataclasses.dataclass
class PartBucket:
    """One static shape class of NS parts, packed and stacked lane-wise.

    Every array is (B, ...) with B the (pow2-padded) lane count.  A lane
    holds one or more parts as disjoint edge-id slices (trussness is
    per-component, so one peel of the lane equals the per-part peels);
    ``part_of`` records the slice ownership.  Local edge id ``cap_e`` is the
    per-lane drop slot that padding triangles point at.
    """

    cap_e: int            # padded local edge capacity per lane (pow4)
    cap_t: int            # padded triangle capacity per lane (pow4)
    n_parts: int          # parts packed into this bucket's lanes
    n_real_lanes: int     # lanes carrying parts (beyond: dead padding)
    sup: np.ndarray       # (B, cap_e) int32 initial supports
    tris: np.ndarray      # (B, cap_t, 3) int32; padding rows -> cap_e
    alive: np.ndarray     # (B, cap_e) bool; padding slots/lanes False
    indptr: np.ndarray    # (B, cap_e + 1) int32 edge->triangle incidence CSR
    tids: np.ndarray      # (B, 3 * cap_t) int32 incidence payload
    edge_ids: np.ndarray  # (B, cap_e) int64 parent edge ids; -1 on padding
    internal: np.ndarray  # (B, cap_e) bool: both endpoints in the part
    part_of: np.ndarray   # (B, cap_e) int32 part index per slot; -1 padding
    real_edges: int       # total unpadded edges across real lanes

    @property
    def n_lanes(self) -> int:
        return self.sup.shape[0]

    @property
    def shape_key(self) -> tuple:
        """The launch-shape key ``peel.peel_classes_batched`` notes for this
        bucket on one device, ((B, cap_e), (B, cap_t, 3)): ``OocStats.
        compiles`` counts the distinct keys of a run."""
        return (tuple(self.sup.shape), tuple(self.tris.shape))

    @property
    def padded_slots(self) -> int:
        return int(self.sup.size)


@dataclasses.dataclass
class PartitionBatch:
    """All NS(P) of one partition round, bucketed and padded."""

    buckets: List[PartBucket]
    n_parts: int
    real_edges: int       # sum of NS edge counts (the round's scan volume)
    padded_slots: int     # sum of lane slots materialized
    max_part_edges: int   # largest single NS (budget-accounting check)
    tri_total: int = 0    # triangles enumerated on the working graph
    tri_assigned: int = 0  # of those, captured by some part
    tri_est: int = 0      # wedge-based triangle estimate of the graph
    tri_peak_rows: int = 0  # most triangle rows held at once while building:
    #                         the whole list when ``tris`` is an array; the
    #                         kept rows plus one chunk when it streams

    @property
    def tri_locality(self) -> float:
        return self.tri_assigned / self.tri_total if self.tri_total else 1.0


def split_bucket_lanes(bucket: PartBucket, factor: int) -> List[PartBucket]:
    """Split a bucket along its lane axis into up to ``factor`` sub-buckets.

    Lanes are independent subproblems (each lane's triangles reference only
    its own slots), so peeling the sub-buckets one at a time equals the
    single peel while each launch holds 1/``factor`` of the device state:
    the lane-split rung of the out-of-core retry ladder.  ``factor`` is
    clamped to the lane count.  Every per-lane array is sliced as it is, so
    a batch built with ``with_incidence=False`` splits too.
    """
    B = bucket.n_lanes
    factor = max(1, min(int(factor), B))
    if factor == 1:
        return [bucket]
    step = -(-B // factor)
    out: List[PartBucket] = []
    for lo in range(0, B, step):
        hi = min(lo + step, B)
        eid = bucket.edge_ids[lo:hi]
        part = bucket.part_of[lo:hi]
        out.append(PartBucket(
            cap_e=bucket.cap_e, cap_t=bucket.cap_t,
            n_parts=int(len(np.unique(part[part >= 0]))),
            n_real_lanes=int(max(0, min(hi, bucket.n_real_lanes) - lo)),
            sup=bucket.sup[lo:hi], tris=bucket.tris[lo:hi],
            alive=bucket.alive[lo:hi], indptr=bucket.indptr[lo:hi],
            tids=bucket.tids[lo:hi], edge_ids=eid,
            internal=bucket.internal[lo:hi], part_of=part,
            real_edges=int((eid >= 0).sum()),
        ))
    return out


def assign_triangles(g: Graph, tris: np.ndarray,
                     part_of: np.ndarray) -> np.ndarray:
    """Part index of every triangle; -1 when its vertices span 3 parts.

    A triangle lies inside NS(P) exactly when >= 2 of its vertices are in
    P, and two disjoint parts cannot both hold two of three vertices, so
    the assignment is unique.
    """
    if len(tris) == 0:
        return np.zeros(0, np.int64)
    e = g.edges.astype(np.int64)
    u = e[tris[:, 0], 0]
    v = e[tris[:, 0], 1]
    x = e[tris[:, 1], 0]
    y = e[tris[:, 1], 1]
    w = np.where((x == u) | (x == v), y, x)   # the third vertex
    pu, pv, pw = part_of[u], part_of[v], part_of[w]
    return np.where(pu == pv, pu, np.where(pu == pw, pu,
                    np.where(pv == pw, pv, -1)))


def build_partition_batch(
    g: Graph,
    parts: Sequence[np.ndarray],
    *,
    with_incidence: bool = True,
    pad_lanes_pow2: bool = True,
    lane_capacity: int | None = None,
    lane_multiple: int = 1,
    tris=None,
    shape_ladder: Sequence[Tuple[int, int, int]] | None = None,
) -> PartitionBatch:
    """Extract, compact, pack and pad every NS(P) of one round.

    The round's triangles are enumerated ONCE on the working graph (scoped
    to the union of the parts' NS) and routed to the part holding two of
    their vertices (``assign_triangles``).  Parts are grouped into pow4 size
    classes and first-fit-decreasing packed into lanes of the class
    capacity; the lane count is padded to a pow2 (``pad_lanes_pow2``).
    ``lane_capacity`` forces every part into one class of that capacity.

    ``lane_multiple`` > 1 (the lane-axis size of a mesh dispatch, so every
    rank peels the same number of lanes) packs waste-aware: every part goes
    into ONE class of capacity ``pow2_ceil(max(max_part, total /
    lane_multiple))`` and the lane count is padded to the device multiple
    only, never to a pow2 first.  ``shape_ladder`` (with it) lists the
    ``(cap_e, cap_t, lanes)`` shapes of the run's earlier buckets: a round
    that fits one is packed into the tightest of them (smallest ``cap_e *
    cap_t``), a round that fits none at its natural shape.  The padding
    either adds is counted in ``padded_slots``.
    ``with_incidence=False`` skips the per-lane supports and incidence CSR.
    ``tris`` passes a precomputed (T, 3) triangle list of the full graph
    ``g`` (the incremental round pipeline), which replaces the enumeration,
    or an iterable of (rows, 3) chunks of such a list (a list spilled to a
    graph store): each chunk is scoped, routed and cut to its assigned rows
    before the next is read, so the whole list is never held; the peak is
    ``PartitionBatch.tri_peak_rows``.
    """
    if lane_capacity is not None and lane_capacity <= 0:
        raise ValueError(
            f"lane_capacity must be positive or None, got {lane_capacity!r}")

    part_of = np.full(g.n, -1, dtype=np.int64)
    for i, P in enumerate(parts):
        part_of[np.asarray(P, dtype=np.int64)] = i
    e64 = g.edges.astype(np.int64)
    in_ns = (part_of[e64[:, 0]] >= 0) | (part_of[e64[:, 1]] >= 0)
    full_scope = bool(in_ns.all())
    # detached: the scoped scan graph lives for this build only and takes
    # no store keys
    g_scan = g if full_scope else g.remove_edges(~in_ns, detach=True)
    if tris is not None and not isinstance(tris, np.ndarray):
        # chunk-streamed: unassigned (three-part) rows are dropped here,
        # where the array path sorts them ahead of part 0; no part's slice
        # reads them either way
        kept_t: List[np.ndarray] = []
        kept_p: List[np.ndarray] = []
        tri_total = tri_assigned = kept_rows = tri_peak_rows = 0
        for chunk in tris:
            tc = np.asarray(chunk, np.int64).reshape(-1, 3)
            tri_peak_rows = max(tri_peak_rows, kept_rows + int(len(tc)))
            if not full_scope and len(tc):
                tc = tc[in_ns[tc].all(axis=1)]
            tri_total += int(len(tc))
            tp = assign_triangles(g, tc, part_of)
            keep = tp >= 0
            tc, tp = tc[keep], tp[keep]
            tri_assigned += int(len(tc))
            kept_rows += int(len(tc))
            if len(tc):
                kept_t.append(tc)
                kept_p.append(tp)
        tri_peak_rows = max(tri_peak_rows, kept_rows)
        tris_g = (np.concatenate(kept_t) if kept_t
                  else np.zeros((0, 3), np.int64))
        tri_part = (np.concatenate(kept_p) if kept_p
                    else np.zeros(0, np.int64))
    else:
        if tris is not None:
            tris_g = np.asarray(tris, np.int64).reshape(-1, 3)
            if not full_scope and len(tris_g):
                tris_g = tris_g[in_ns[tris_g].all(axis=1)]
        else:
            tris_g = np.asarray(list_triangles(g_scan),
                                np.int64).reshape(-1, 3)
            if not full_scope and len(tris_g):
                tris_g = np.nonzero(in_ns)[0][tris_g]  # back to g's ids
        tri_part = assign_triangles(g, tris_g, part_of)
        tri_total = int(len(tris_g))
        tri_assigned = int((tri_part >= 0).sum())
        tri_peak_rows = tri_total
    tri_est = int(closed_wedge_estimate(g_scan).sum()) // 3
    order = np.argsort(tri_part, kind="stable")
    tris_sorted = tris_g[order]
    bounds = np.searchsorted(tri_part[order], np.arange(len(parts) + 1))

    per_part = []
    for i, (ids, internal) in enumerate(ns_edge_lists(g, parts, part_of)):
        if len(ids) == 0:
            continue
        # global edge ids -> part-local slots (every edge of an assigned
        # triangle is in NS(P) by construction)
        local = compact_index(ids, tris_sorted[bounds[i]:bounds[i + 1]])
        per_part.append((ids, internal, len(ids), local))

    if not per_part:
        return PartitionBatch(buckets=[], n_parts=0, real_edges=0,
                              padded_slots=0, max_part_edges=0,
                              tri_total=tri_total, tri_assigned=tri_assigned,
                              tri_est=tri_est, tri_peak_rows=tri_peak_rows)

    groups: dict[int, List[int]] = {}
    floor_t, floor_l = 1, 1
    if lane_multiple > 1:
        # waste-aware mesh packing: one class sized to the observed cap
        sizes = [item[2] for item in per_part]
        tri_lens = [len(item[3]) for item in per_part]
        floor_cap = 1 if lane_capacity is None else lane_capacity
        key = _pow2_ceil(max(max(sizes), -(-sum(sizes) // lane_multiple),
                             floor_cap))
        # the tightest ladder shape the round fits (a trial FFD pack each)
        for fe, ft, fl in sorted(shape_ladder or (),
                                 key=lambda s: s[0] * s[1]):
            if fe < max(max(sizes), floor_cap):
                continue
            trial = _first_fit_decreasing(sizes, fe)
            if len(trial) > fl or max(
                    sum(tri_lens[i] for i in lane) for lane in trial) > ft:
                continue
            key, floor_t, floor_l = fe, ft, fl
            break
        groups[key] = list(range(len(per_part)))
    else:
        for idx, item in enumerate(per_part):
            if lane_capacity is not None and item[2] <= lane_capacity:
                key = lane_capacity
            else:
                key = _pow4_ceil(item[2])
            groups.setdefault(key, []).append(idx)

    buckets: List[PartBucket] = []
    total_real = total_pad = max_part = 0
    for cap_e in sorted(groups):
        members = groups[cap_e]
        packed = _first_fit_decreasing([per_part[i][2] for i in members],
                                       cap_e)
        lanes = [[members[i] for i in lane] for lane in packed]
        lane_T = [sum(len(per_part[i][3]) for i in lane) for lane in lanes]
        cap_t = _pow4_ceil(max(max(lane_T), 1))
        n_real_lanes = len(lanes)
        if lane_multiple > 1:
            # equal lanes per rank; a ladder shape pins T and the lanes too
            cap_t = max(cap_t, floor_t)
            B = round_up_to_multiple(max(n_real_lanes, floor_l),
                                     lane_multiple)
        elif pad_lanes_pow2:
            B = _pow2_ceil(n_real_lanes)
        else:
            B = n_real_lanes
        sup_b = np.zeros((B, cap_e), np.int32)
        tris_b = np.full((B, cap_t, 3), cap_e, np.int32)
        alive_b = np.zeros((B, cap_e), bool)
        indptr_b = np.zeros((B, cap_e + 1), np.int32)
        tids_b = np.zeros((B, 3 * cap_t), np.int32)
        eid_b = np.full((B, cap_e), -1, np.int64)
        int_b = np.zeros((B, cap_e), bool)
        part_b = np.full((B, cap_e), -1, np.int32)
        real_edges = 0
        for lane_idx, lane in enumerate(lanes):
            off_e = off_t = 0
            for part_idx in lane:
                ids, internal, m_loc, tri_loc = per_part[part_idx]
                sl = slice(off_e, off_e + m_loc)
                alive_b[lane_idx, sl] = True
                eid_b[lane_idx, sl] = ids
                int_b[lane_idx, sl] = internal
                part_b[lane_idx, sl] = part_idx
                if len(tri_loc):
                    tris_b[lane_idx, off_t: off_t + len(tri_loc)] = \
                        tri_loc + off_e
                if with_incidence:
                    sup_b[lane_idx, sl] = support_from_triangle_list(
                        tri_loc, m_loc)
                off_e += m_loc
                off_t += len(tri_loc)
                max_part = max(max_part, m_loc)
            real_edges += off_e
            if with_incidence:
                indptr, tids = triangle_incidence_np(tris_b[lane_idx], cap_e)
                indptr_b[lane_idx] = indptr
                tids_b[lane_idx, : len(tids)] = tids
        buckets.append(PartBucket(
            cap_e=cap_e, cap_t=cap_t, n_parts=len(members),
            n_real_lanes=n_real_lanes, sup=sup_b, tris=tris_b,
            alive=alive_b, indptr=indptr_b, tids=tids_b, edge_ids=eid_b,
            internal=int_b, part_of=part_b, real_edges=real_edges,
        ))
        total_real += real_edges
        total_pad += buckets[-1].padded_slots

    return PartitionBatch(
        buckets=buckets, n_parts=len(per_part), real_edges=total_real,
        padded_slots=total_pad, max_part_edges=max_part,
        tri_total=tri_total, tri_assigned=tri_assigned, tri_est=tri_est,
        tri_peak_rows=tri_peak_rows,
    )
