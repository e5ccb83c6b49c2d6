"""Bottom-up I/O-efficient truss decomposition (paper Section 5, Alg 3-5).

Port of the batched engine of ``repro.core.bottom_up``.

Stage 1 — ``lower_bounding`` (Algorithm 3): partition the working graph into
parts whose neighbourhood subgraphs fit the budget and decompose every
NS(P) locally; Lemma 1 makes the local trussness a lower bound of phi(e).
Internal edges leave the working graph after each round (to ``G_new``) and
the loop repeats on the remainder.  One round is one
:class:`partition.PartitionBatch`: every bucket of lanes peels in lockstep
through the fused round kernel (``peel.peel_classes_batched``).  Rounds are
double-buffered: a round's internal edges are known when its batch is
built, so the producer builds round r + 1 before round r's results are
consumed, one round late.

Stage 2 — ``bottom_up_decompose`` (Algorithm 4 + Procedure 5): for
ascending k, the candidate H = NS(U_k), U_k the endpoints of undecided edges
with lb <= k, is compacted and peeled at threshold k - 2
(``peel.local_threshold_peel``); the removed internal edges are Phi_k.
Level k+1's candidate is pre-built from the masks before level k's result
is read (a superset of U_{k+1}, which is sound); the edges level k removed
are then killed through the peel's ``alive0`` mask.

Deviation from the paper (as in the reference): Phi_2 is flagged exactly
only in round 1 (later rounds measure supports on the shrunk working graph)
and stage 2 starts at k = 2.

Not ported yet (ROADMAP): the round journal and resume, the retry ladders,
the graph store, the locality partitioner and the mesh paths.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Iterator, List, Tuple

import numpy as np

from repro_torch.core import graph as glib
from repro_torch.core import partition as plib
from repro_torch.core.peel import (local_threshold_peel, peel_classes_batched,
                                   reject_unported)
from repro_torch.core.support import (list_triangles,
                                      support_from_triangle_list)
from repro_torch.device import resolve_device
from repro_torch.kernels import check_kernel


def _resolve_partitioner(partitioner: str, seed: int = 0):
    """Normalize a partitioner name to fn(graph, budget, round_idx) -> parts.

    The randomized partitioner is re-seeded every round (``seed + round``):
    Chu–Cheng's guarantee that crossing edges eventually co-locate holds
    only under re-randomization.
    """
    if partitioner == "locality":
        raise NotImplementedError(
            "partitioner='locality' is not ported to repro_torch yet: "
            "ROADMAP A8 (locality partitioner)")
    if partitioner not in plib.PARTITIONERS:
        raise ValueError(f"unknown partitioner {partitioner!r}; expected one "
                         f"of {sorted(plib.PARTITIONERS)}")
    fn = plib.PARTITIONERS[partitioner]
    if partitioner == "random":
        return lambda g, b, r: fn(g, b, seed=seed + r)
    return lambda g, b, r: fn(g, b)


@dataclasses.dataclass
class OocStats:
    """Work counters of one out-of-core run.

    The integer counters are defined as in ``repro.core.bottom_up.OocStats``
    (``compiles`` counts distinct launch shapes here, there being no XLA
    compile).  The ``*_s`` fields are host wall-clock seconds: building the
    stage-1 partition batches (partitioning, triangle routing, lane packing,
    graph maintenance), building the stage-2 / top-down candidates
    (extraction, compaction, triangle listing), and the device peels
    (dispatch to result).
    """

    rounds: int = 0           # partition rounds (the paper's O(m/M) scans)
    scans: int = 0            # NS/candidate extractions (I/O-scan analogue)
    batches: int = 0          # device peels (one per bucket per round/level)
    compiles: int = 0         # distinct launch shapes of this run
    parts: int = 0            # NS parts processed
    max_part_edges: int = 0   # largest NS working set seen (budget check)
    real_edges: int = 0       # sum of real edge slots across all batches
    padded_slots: int = 0     # sum of materialized lane slots
    tri_total: int = 0        # triangles enumerated across partition rounds
    tri_assigned: int = 0     # of those, captured inside some part
    ns_sweeps: int = 0        # whole-graph NS edge-list sweeps (1 per batch)
    overlapped: int = 0       # rounds built while the previous was pending
    stage2_overlapped: int = 0  # levels whose candidate was pre-built
    tri_est: int = 0          # wedge-based triangle estimates, summed
    tri_rescans_avoided: int = 0  # rounds that filtered the previous
    #                           round's triangle list instead of listing
    round_build_s: float = 0.0      # host: stage-1 batch building
    candidate_build_s: float = 0.0  # host: candidate building
    peel_s: float = 0.0             # device peels, dispatch to result

    @property
    def padding_waste(self) -> float:
        if not self.padded_slots:
            return 0.0
        return 1.0 - self.real_edges / self.padded_slots

    @property
    def tri_locality(self) -> float:
        return self.tri_assigned / self.tri_total if self.tri_total else 1.0

    @property
    def tri_est_error(self) -> float:
        return abs(self.tri_est - self.tri_total) / max(self.tri_total, 1)

    def absorb_batch(self, batch: plib.PartitionBatch) -> None:
        self.parts += batch.n_parts
        self.scans += batch.n_parts
        self.batches += len(batch.buckets)
        self.real_edges += batch.real_edges
        self.padded_slots += batch.padded_slots
        self.max_part_edges = max(self.max_part_edges, batch.max_part_edges)
        self.tri_total += batch.tri_total
        self.tri_assigned += batch.tri_assigned
        self.tri_est += batch.tri_est
        self.ns_sweeps += 1


@dataclasses.dataclass
class LowerBoundResult:
    edges: np.ndarray        # canonical edge list of the original graph
    phi: np.ndarray          # trussness; filled with 2 for the exact Phi_2
    lb: np.ndarray           # lower bound phi(e) for G_new edges (>= 2)
    in_gnew: np.ndarray      # bool mask: edge still undecided (in G_new)
    stats: OocStats


def _partition_rounds(
    n: int, edges: np.ndarray, budget: int, part_fn, stats: OocStats,
) -> Iterator[Tuple[int, plib.PartitionBatch, np.ndarray]]:
    """Producer side of the double-buffered round pipeline.

    Yields ``(round_idx, batch, cur_ids)`` per partition round, ``cur_ids``
    mapping the batch's current-graph edge ids to original ids.  The round's
    internal edges leave the working graph (``Graph.remove_edges``) before
    the yield.  A round with no internal edge doubles the budget and yields
    nothing.  The triangle list is enumerated once and filtered against the
    surviving edges in later rounds.
    """
    g = glib.build_graph(n, edges)
    cur_ids = np.arange(g.m, dtype=np.int64)
    cur_budget = budget
    tris_cur = None      # full triangle list of g, g-local edge ids
    while g.m:
        t0 = time.perf_counter()
        stats.rounds += 1
        parts = part_fn(g, cur_budget, stats.rounds)
        if not parts:
            break
        if tris_cur is None:
            tris_cur = np.asarray(list_triangles(g), np.int64).reshape(-1, 3)
        else:
            stats.tri_rescans_avoided += 1
        batch = plib.build_partition_batch(g, parts, tris=tris_cur)
        stats.absorb_batch(batch)
        removed = np.zeros(g.m, dtype=bool)
        for bucket in batch.buckets:
            removed[bucket.edge_ids[bucket.internal]] = True
        if not removed.any():
            # the batch is discarded un-launched
            stats.batches -= len(batch.buckets)
            cur_budget *= 2
            stats.round_build_s += time.perf_counter() - t0
            continue
        ids_snapshot = cur_ids
        cur_ids = cur_ids[~removed]
        g = g.remove_edges(removed)
        remap = np.cumsum(~removed) - 1          # old id -> compacted id
        if len(tris_cur):
            tris_cur = remap[tris_cur[~removed[tris_cur].any(axis=1)]]
        stats.round_build_s += time.perf_counter() - t0
        yield stats.rounds, batch, ids_snapshot


def lower_bounding(n: int, edges: np.ndarray, budget: int,
                   partitioner: str = "sequential", *,
                   partitioner_seed: int = 0, kernel: str = "auto",
                   device=None) -> LowerBoundResult:
    """Algorithm 3: per-edge lower bounds plus the exact round-1 Phi_2."""
    check_kernel(kernel)
    dev = resolve_device(device)
    part_fn = _resolve_partitioner(partitioner, seed=partitioner_seed)
    edges = glib.canonical_edges(edges, n)
    m = len(edges)
    phi = np.zeros(m, dtype=np.int64)
    lb = np.full(m, 2, dtype=np.int64)
    in_gnew = np.zeros(m, dtype=bool)
    stats = OocStats()
    shape_cache: set = set()

    def fold_bucket(round_idx, bucket, ids, phi_b):
        """Fold one bucket's local trussness into lb/phi/in_gnew; internal
        edges live in exactly one part, so the scatters never collide."""
        int_mask = bucket.internal
        glob = ids[bucket.edge_ids[int_mask]]
        phi_int = phi_b[int_mask].astype(np.int64)
        np.maximum.at(lb, glob, phi_int)
        if round_idx == 1:
            # exact Phi_2: internal support == global support in round 1
            is2 = phi_int == 2
            phi[glob[is2]] = 2
            in_gnew[glob[~is2]] = True
        else:
            in_gnew[glob] = True

    def consume(pending):
        round_idx, batch, ids, handles = pending
        t0 = time.perf_counter()
        results = [h.result()[0] for h in handles]
        stats.peel_s += time.perf_counter() - t0
        for bucket, phi_b in zip(batch.buckets, results):
            fold_bucket(round_idx, bucket, ids, phi_b)

    # double-buffered rounds: dispatch round r, let the generator build
    # round r + 1, then consume r's results
    pending = None
    for round_idx, batch, ids in _partition_rounds(n, edges, budget, part_fn,
                                                   stats):
        t0 = time.perf_counter()
        handles = []
        for bucket in batch.buckets:
            h = peel_classes_batched(bucket.sup, bucket.tris, bucket.alive,
                                     shape_cache=shape_cache, blocking=False,
                                     kernel=kernel, device=dev)
            stats.compiles += int(h.new_compile)
            handles.append(h)
        stats.peel_s += time.perf_counter() - t0
        if pending is not None:
            stats.overlapped += 1
            consume(pending)
        pending = (round_idx, batch, ids, handles)
    if pending is not None:
        consume(pending)
    return LowerBoundResult(edges=edges, phi=phi, lb=lb, in_gnew=in_gnew,
                            stats=stats)


@dataclasses.dataclass
class BottomUpResult:
    edges: np.ndarray
    phi: np.ndarray
    kmax: int
    rounds: int
    scans: int
    candidate_sizes: List[int]   # |H| per k (I/O + working-set accounting)
    stats: OocStats


def bottom_up_decompose(n: int, edges: np.ndarray, budget: int,
                        partitioner: str = "sequential", *,
                        partitioner_seed: int = 0, kernel: str = "auto",
                        device=None, mesh=None, checkpoint_dir=None,
                        resume: bool = False,
                        store=None) -> BottomUpResult:
    """Algorithm 4: full decomposition under a working-set budget (NS edge
    entries per part).  ``device=None`` means the CUDA card; the mesh,
    journal and store arguments of the reference raise
    ``NotImplementedError`` when set."""
    reject_unported(mesh=mesh, checkpoint_dir=checkpoint_dir, resume=resume,
                    store=store)
    check_kernel(kernel)
    dev = resolve_device(device)
    lbres = lower_bounding(n, edges, budget, partitioner,
                           partitioner_seed=partitioner_seed, kernel=kernel,
                           device=dev)
    edges, lb, stats = lbres.edges, lbres.lb, lbres.stats
    phi = lbres.phi.copy()
    remaining = lbres.in_gnew.copy()
    cand_sizes: List[int] = []
    shape_cache: set = set()

    def build_candidate(k_b: int):
        """Host half of one stage-2 level: NS(U_k) from the current
        ``remaining`` mask, compacted and triangle-listed; None when no
        remaining edge admits class k_b.  Built one level ahead, its U is a
        superset of the true U_{k+1}, which is sound (see the reference)."""
        t0 = time.perf_counter()
        try:
            elig = remaining & (lb <= k_b)
            if not elig.any():
                return None
            u_k = np.zeros(n, dtype=bool)
            eg = edges[elig]
            u_k[eg[:, 0]] = True
            u_k[eg[:, 1]] = True
            u_in = u_k[edges[:, 0]]
            v_in = u_k[edges[:, 1]]
            h_ids = np.nonzero(remaining & (u_in | v_in))[0]
            internal = remaining & u_in & v_in
            local_edges, verts = glib.compact_edge_list(edges[h_ids])
            sub = glib.build_graph(len(verts), local_edges)
            tris = np.asarray(list_triangles(sub), np.int32).reshape(-1, 3)
            return k_b, h_ids, tris, internal
        finally:
            stats.candidate_build_s += time.perf_counter() - t0

    k = 2
    pre = None          # candidate pre-built while the previous level peeled
    while remaining.any():
        # skip empty classes: jump k straight to the smallest lower bound
        k = max(k, int(lb[remaining].min()))
        stats.scans += 1
        if pre is not None and pre[0] == k:
            cand = pre
            stats.stage2_overlapped += 1
        else:
            cand = build_candidate(k)
        _, h_ids, tris, internal = cand
        cand_sizes.append(len(h_ids))
        # kill the edges the previous level removed after this candidate was
        # built; supports count fully-alive triangles
        alive_h = remaining[h_ids]
        if len(tris):
            t_alive = (alive_h[tris[:, 0]] & alive_h[tris[:, 1]]
                       & alive_h[tris[:, 2]])
            sup = support_from_triangle_list(
                tris[t_alive], len(h_ids)).astype(np.int32)
        else:
            sup = np.zeros(len(h_ids), np.int32)
        t0 = time.perf_counter()
        handle = local_threshold_peel(
            sup, tris, internal[h_ids], k - 2, alive0=alive_h,
            shape_cache=shape_cache, blocking=False, kernel=kernel,
            device=dev)
        stats.peel_s += time.perf_counter() - t0
        stats.compiles += int(handle.new_compile)
        stats.batches += 1
        pre = build_candidate(k + 1)
        t0 = time.perf_counter()
        _, removed = handle.result()
        stats.peel_s += time.perf_counter() - t0
        rm_glob = h_ids[removed]
        phi[rm_glob] = k
        remaining[rm_glob] = False
        k += 1

    kmax = int(phi.max()) if len(phi) else 2
    return BottomUpResult(edges=edges, phi=phi, kmax=kmax,
                          rounds=stats.rounds, scans=stats.scans,
                          candidate_sizes=cand_sizes, stats=stats)
