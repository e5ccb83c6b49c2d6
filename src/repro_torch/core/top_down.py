"""Top-down truss decomposition for the top-t classes (paper Section 6).

Port of ``repro.core.top_down`` without a working-set budget.

``upper_bounds`` implements Procedure 6 / Lemma 2: for e = (u, v),
``psi(e) = min(sup(e), x_u, x_v) + 2`` where ``x_w`` is the largest x such
that x edges at w other than e have support >= x (an h-index).

``top_down_decompose`` implements Algorithm 7: supports of the whole graph
come from ``support.edge_support_auto`` (dense cores through the
dense-support kernel, sparse graphs through the wedge scan); classes are
then extracted from k = max(psi) downward.  Per k, the candidate H =
NS(U_k), U_k the vertices of undecided alive edges with psi >= k, is
compacted and peeled at threshold k - 3 (``peel.local_threshold_peel``);
the surviving tentative edges are Phi_k.  Classified edges that share no
triangle with an undecided edge are pruned (Steps 7-9).  The next level's
candidate is pre-built before the current level's result is read.

With a ``budget``, stage 1 is ``bottom_up.partitioned_support``: exact
supports under the working-set budget, by partition rounds on the host,
optionally with the working graph in a graph store (``store=``).  The
levels then peel through the fused round kernel as without one; they work
on G_new, which stays on the host.

Deviation from the paper (as in the reference, which proves it exact):
external unclassified edges are excluded from the candidate peel;
``faithful_proc8=True`` restores the paper's literal Procedure 8.

Journal and retries as in ``bottom_up``: stage-1 credit rounds are "sup"
snapshots, completed levels "td" snapshots; a failed level peel walks
``bottom_up._retry_candidate_peel``.  With a ``mesh`` every level's
candidate peel is triangle-sharded over its ranks (``core.distributed``).
"""

from __future__ import annotations

import dataclasses
import time
from typing import List, Optional, Union

import numpy as np

from repro_torch.core import graph as glib
from repro_torch.core.bottom_up import (OocStats, RoundJournal, _dispatch,
                                        _Engine, _retry_candidate_peel,
                                        _run_key, partitioned_support)
from repro_torch.core.peel import local_threshold_peel
from repro_torch.core.support import (edge_support_auto, list_triangles,
                                      support_from_triangle_list)
from repro_torch.device import resolve_device
from repro_torch.kernels import check_kernel


def upper_bounds(n: int, edges: np.ndarray, sup: np.ndarray) -> np.ndarray:
    """Procedure 6: psi(e) upper bound on trussness, vectorized."""
    m = len(edges)
    if m == 0:
        return np.zeros(0, np.int64)
    sup = np.asarray(sup, dtype=np.int64)
    inc_v = np.concatenate([edges[:, 0], edges[:, 1]]).astype(np.int64)
    inc_e = np.concatenate([np.arange(m), np.arange(m)]).astype(np.int64)
    inc_s = sup[inc_e]
    order = np.lexsort((-inc_s, inc_v))
    v_sorted = inc_v[order]
    s_sorted = inc_s[order]
    seg_start = np.zeros(n + 1, dtype=np.int64)
    np.add.at(seg_start, v_sorted + 1, 1)
    seg_start = np.cumsum(seg_start)
    r = np.arange(len(v_sorted), dtype=np.int64) - seg_start[v_sorted] + 1
    # h0(v) = #{r : s_r >= r}; s_r - r strictly decreases within a segment
    h0 = np.zeros(n, dtype=np.int64)
    np.add.at(h0, v_sorted, (s_sorted >= r).astype(np.int64))
    # the (h0+1)-th largest incident support (0 if none)
    deg = seg_start[1:] - seg_start[:-1]
    idx = seg_start[:-1] + h0
    s_next = np.where(h0 < deg,
                      s_sorted[np.minimum(idx, len(s_sorted) - 1)], 0)

    def x_at(vcol):
        """x_v(e): v's h-index with e excluded."""
        v = edges[:, vcol].astype(np.int64)
        h = h0[v]
        drop = (sup >= h) & ~(s_next[v] >= np.maximum(h, 1))
        x = np.where(sup < h, h, np.where(drop, h - 1, h))
        return np.maximum(x, 0)

    return np.minimum(sup, np.minimum(x_at(0), x_at(1))) + 2


@dataclasses.dataclass
class TopDownResult:
    edges: np.ndarray
    phi: np.ndarray          # 0 = undecided (beyond the requested top-t)
    classes: List[int]       # the k values emitted, descending
    kmax: int
    candidate_sizes: List[int]
    pruned: int              # edges pruned by Steps 7-9
    stats: OocStats


def top_down_decompose(n: int, edges: np.ndarray, t: Optional[int] = None,
                       budget: Optional[int] = None,
                       partitioner: str = "sequential",
                       faithful_proc8: bool = False, *,
                       partitioner_seed: int = 0, kernel: str = "auto",
                       checkpoint_dir=None,
                       checkpoint_every: Union[int, str] = 1,
                       resume: bool = False, checkpoint_keep: int = 3,
                       max_retries: int = 2, store=None, mesh=None,
                       mesh_axis="data", device=None) -> TopDownResult:
    """Algorithm 7: the top-t k-classes (all classes if t is None).

    ``budget`` (NS edge entries per part) runs stage 1 as
    ``partitioned_support`` with ``partitioner`` / ``partitioner_seed``;
    without it the supports of the whole graph come from
    ``edge_support_auto`` on ``device``.

    ``checkpoint_dir`` journals stage-1 rounds ("sup") and completed levels
    ("td") every ``checkpoint_every`` events, keeping ``checkpoint_keep``;
    ``resume=True`` continues from the newest intact snapshot to the phi of
    an uninterrupted run (psi, G_new and its triangle list are recomputed
    from the journaled supports).  ``max_retries`` bounds the retries of a
    failed level peel or credit round.  ``store`` routes stage 1's working
    graph through a graph store and needs a ``budget`` (the unbudgeted
    supports are computed over the whole resident graph).  ``device=None``
    means the CUDA card.

    ``mesh`` (every rank of it makes the same call) triangle-shards every
    level's candidate peel over ``mesh_axis``, or over the flattened
    product of a tuple of names; ``OocStats.devices`` / ``sharded_rounds``
    record the routing, and the journal's run key binds the device count.
    """
    check_kernel(kernel)
    dev = resolve_device(device)
    edges = glib.canonical_edges(edges, n)
    m = len(edges)
    phi = np.zeros(m, dtype=np.int64)
    eng = _Engine(kernel=kernel, device=dev, mesh=mesh, mesh_axis=mesh_axis)
    stats = OocStats(devices=eng.devices)
    if store is not None and budget is None:
        raise ValueError(
            "store= requires a working-set budget (the unbudgeted support "
            "path computes over the whole resident graph)")
    if m == 0:
        return TopDownResult(edges, phi, [], 2, [], 0, stats)

    journal = snap = None
    if checkpoint_dir is not None:
        key = _run_key("top_down", n, edges, budget, partitioner,
                       partitioner_seed, t=t, faithful=bool(faithful_proc8),
                       devices=eng.devices)
        journal = RoundJournal(checkpoint_dir, key, every=checkpoint_every,
                               keep=checkpoint_keep, store=store, mesh=mesh)
        if resume:
            snap = journal.load_latest()
    td_snap = snap if snap is not None and snap[1].get("stage") == "td" \
        else None

    # stage 1: exact supports; Phi_2 = zero-support edges.  A "td" snapshot
    # carries the finished supports, so stage 1 is skipped.
    if td_snap is not None:
        sup = np.asarray(td_snap[0]["sup"], dtype=np.int64)
        stats = OocStats.from_dict(td_snap[1]["stats"])
        stats.resumed_round = int(td_snap[1]["index"])
        stats.devices = eng.devices
    elif budget is None:
        sup = edge_support_auto(glib.build_graph(n, edges), device=dev)
    else:
        sup, stats = partitioned_support(
            n, edges, budget, partitioner, with_stats=True,
            partitioner_seed=partitioner_seed, mesh=mesh,
            mesh_axis=mesh_axis, journal=journal,
            restored=snap if snap is not None
            and snap[1].get("stage") == "sup" else None,
            max_retries=max_retries, store=store)
    phi[sup == 0] = 2
    alive = sup > 0                      # G_new
    psi = upper_bounds(n, edges, sup)

    # one static triangle list over G_new; every candidate filters it
    gnew = glib.build_graph(n, edges[alive])
    gnew_ids = np.nonzero(alive)[0]
    tris_l = np.asarray(list_triangles(gnew), dtype=np.int64).reshape(-1, 3)
    shape_cache: set = set()
    # masks below are in G_new-local edge ids
    alive_l = np.ones(gnew.m, dtype=bool)
    classified_l = np.zeros(gnew.m, dtype=bool)
    psi_l = psi[gnew_ids]
    edges_l = edges[gnew_ids]
    classes: List[int] = []
    cand_sizes: List[int] = []
    pruned_total = 0
    k = int(psi_l.max()) if gnew.m else 2
    if td_snap is not None:
        # the snapshot's masks are the state after level ``index``
        # completed, so the next level is ``index - 1``
        tree, meta = td_snap
        phi = np.asarray(tree["phi"], dtype=np.int64)
        alive_l = np.asarray(tree["alive_l"], dtype=bool)
        classified_l = np.asarray(tree["classified_l"], dtype=bool)
        classes = [int(c) for c in meta.get("classes", [])]
        cand_sizes = [int(c) for c in meta.get("cand_sizes", [])]
        pruned_total = int(meta.get("pruned", 0))
        k = int(meta["index"]) - 1

    def build_candidate(k_b: int):
        """U_k from the current alive / classified masks, the candidate
        compacted and its triangles filtered from the G_new list.  Built
        one level ahead it is a superset of the true candidate, which is
        sound (see the reference); None when no undecided alive edge has
        psi >= k_b."""
        t0 = time.perf_counter()
        try:
            return _candidate(k_b)
        finally:
            stats.candidate_build_s += time.perf_counter() - t0

    def _candidate(k_b: int):
        elig = alive_l & ~classified_l & (psi_l >= k_b)
        if not elig.any():
            return None
        u_k = np.zeros(n, dtype=bool)
        eg = edges_l[elig]
        u_k[eg[:, 0]] = True
        u_k[eg[:, 1]] = True
        u_in = u_k[edges_l[:, 0]]
        v_in = u_k[edges_l[:, 1]]
        in_h = alive_l & (u_in | v_in)
        internal = u_in & v_in           # re-masked by alive at use time
        if faithful_proc8:
            cand_set = in_h
        else:
            cand_set = ((internal & alive_l & ~classified_l)
                        | (classified_l & in_h))
        h_l = np.nonzero(cand_set)[0]
        tmask = (cand_set[tris_l[:, 0]] & cand_set[tris_l[:, 1]]
                 & cand_set[tris_l[:, 2]])
        # h_l-local ids by a lookup table (one gather per corner, where
        # glib.compact_index binary-searches h_l)
        slot = np.zeros(gnew.m, np.int32)
        slot[h_l] = np.arange(len(h_l), dtype=np.int32)
        tris_loc = slot[tris_l[tmask]]
        return k_b, h_l, tris_loc, internal, int(in_h.sum())

    def peel_level(k_b, sup0, tris_loc, removable, alive_h, retry):
        """Dispatch one level's peel (non-blocking)."""
        h = _dispatch(eng, eng.mesh, lambda: local_threshold_peel(
            sup0, tris_loc, removable, k_b - 3, alive0=alive_h,
            shape_cache=shape_cache, blocking=False, mesh=eng.mesh,
            mesh_axis=eng.mesh_axis, kernel=eng.kernel, device=eng.device,
            fault_ctx={"stage": "td", "k": int(k_b), "retry": retry}))
        stats.compiles += int(h.new_compile)
        stats.batches += 1
        stats.sharded_rounds += int(h.sharded)
        return h

    pre = None          # candidate pre-built while the previous level peeled
    while k >= 3 and (t is None or len(classes) < t):
        undecided = alive_l & ~classified_l
        if not undecided.any():
            break
        if not (undecided & (psi_l >= k)).any():
            k = int(psi_l[undecided].max())
            continue
        if pre is not None and pre[0] == k and not faithful_proc8:
            cand = pre
            stats.stage2_overlapped += 1
        else:
            cand = build_candidate(k)
        pre = None
        _, h_l, tris_loc, internal, in_h_size = cand
        tentative = internal & alive_l & ~classified_l
        cand_sizes.append(in_h_size)
        stats.scans += 1
        # kill candidate edges pruned after a pre-build; supports count
        # fully-alive triangles
        alive_h = alive_l[h_l]
        if len(tris_loc):
            t_alive = (alive_h[tris_loc[:, 0]] & alive_h[tris_loc[:, 1]]
                       & alive_h[tris_loc[:, 2]])
            sup0 = support_from_triangle_list(
                tris_loc[t_alive], len(h_l)).astype(np.int32)
        else:
            sup0 = np.zeros(len(h_l), np.int32)
        removable = tentative[h_l]
        handle = dispatch_exc = None
        t0 = time.perf_counter()
        try:
            handle = peel_level(k, sup0, tris_loc, removable, alive_h, 0)
        except Exception as exc:
            dispatch_exc = exc          # enters the retry ladder below
        stats.peel_s += time.perf_counter() - t0
        if not faithful_proc8:
            pre = build_candidate(k - 1)
        ta = (alive_l[tris_l[:, 0]] & alive_l[tris_l[:, 1]]
              & alive_l[tris_l[:, 2]])
        t0 = time.perf_counter()
        try:
            if dispatch_exc is not None:
                raise dispatch_exc
            surv_l, _ = handle.result()
        except Exception as exc:
            surv_l = _retry_candidate_peel(
                eng, stats, exc, lambda retry: peel_level(
                    k, sup0, tris_loc, removable, alive_h, retry).result()[0],
                max_retries)
        stats.peel_s += time.perf_counter() - t0
        phi_k = np.zeros(gnew.m, dtype=bool)
        phi_k[h_l[surv_l]] = True
        phi_k &= tentative
        if phi_k.any():
            classes.append(k)
            classified_l |= phi_k
            phi[gnew_ids[phi_k]] = k
            # Steps 7-9: prune classified edges with no undecided triangle
            und = alive_l & ~classified_l
            tri_needs = ta & (und[tris_l[:, 0]] | und[tris_l[:, 1]]
                              | und[tris_l[:, 2]])
            needs = np.bincount(tris_l[tri_needs].reshape(-1),
                                minlength=gnew.m)
            prunable = alive_l & classified_l & (needs == 0)
            pruned_total += int(prunable.sum())
            alive_l &= ~prunable
        if journal is not None:
            journal.record(
                "td", k,
                {"phi": phi, "sup": sup, "alive_l": alive_l,
                 "classified_l": classified_l},
                stats, classes=[int(c) for c in classes],
                cand_sizes=[int(c) for c in cand_sizes],
                pruned=int(pruned_total))
        k -= 1

    kmax = classes[0] if classes else 2
    return TopDownResult(edges=edges, phi=phi, classes=classes, kmax=kmax,
                         candidate_sizes=cand_sizes, pruned=pruned_total,
                         stats=stats)
