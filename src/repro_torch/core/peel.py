"""Bulk-synchronous truss peeling on a device (port of ``repro.core.peel``).

Every round removes the alive edges with ``sup <= k - 2`` and repairs the
supports of the survivors from the triangle list; rounds iterate at one k to
a fixed point, then k jumps to ``min alive support + 2``.  This yields the
same k-classes as the serial algorithm.

Engines:

* the **frontier** engine (``peel_classes`` / ``peel_threshold``): each
  round compacts the removed-edge frontier into ``cap_f`` slots (cumsum
  stream compaction), gathers only the triangles incident to it through the
  edge -> triangle incidence CSR (``cap_t`` slots, searchsorted over the
  prefix sums), charges a triangle hit by several removed edges to the
  smallest one (owner dedup) and scatters the decrements.  A frontier larger
  than the capacities is taken in prefixes (peeling is confluent); an
  incidence row larger than ``cap_t`` doubles ``cap_t`` and resumes.
* the **dense** engine (``peel_classes_dense`` / ``peel_threshold_dense``):
  every round rescans the whole triangle list — the baseline.
* the **batched local peels** of the out-of-core drivers
  (``peel_classes_batched`` over the (B, cap_e) lanes of a partition
  bucket, ``local_threshold_peel`` over one compacted candidate), which run
  the fused round kernel of ``kernels.frontier_peel``.

JAX runs each peel as one ``lax.while_loop`` on the device.  Here the loops
are host loops over device tensors: every iteration reads its loop-control
flags in ONE transfer (``device.host_read``); all other state stays on the
device.
"""

from __future__ import annotations

import contextlib
import dataclasses
import tempfile
import warnings
from typing import Optional

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.core.graph import build_graph, canonical_edges
from repro_torch.core.support import (_pow2_ceil, _pow4_ceil,
                                      list_triangles,
                                      support_from_triangle_list,
                                      triangle_incidence_np)
from repro_torch.device import host_read, resolve_device
from repro_torch.kernels import check_kernel
from repro_torch.kernels.frontier_peel import ops as frontier_ops
# the stats vector layout (sub-rounds, edges removed, incidence slots
# gathered, max single-round frontier) is shared with the fused loops
from repro_torch.kernels.frontier_peel.ops import (_S_GATHERED, _S_MAXF,
                                                   _S_REMOVED, _S_ROUNDS,
                                                   N_STATS)
from repro_torch.kernels.frontier_peel.ref import BIG

# arguments of the JAX package's entry points that this port does not carry
# yet, with the ROADMAP item each waits for
_NOT_PORTED = {
    "mesh": "A13 (distributed mesh paths)",
    "mesh_axes": "A13 (distributed mesh paths)",
}


def reject_unported(**kwargs) -> None:
    """Raise ``NotImplementedError`` for any argument of the reference
    entry points that is set but not ported yet (never ignore one)."""
    for name, value in kwargs.items():
        if value is not None and value is not False:
            raise NotImplementedError(
                f"{name}= is not ported to repro_torch yet: ROADMAP "
                f"{_NOT_PORTED[name]}")


def _put(x, dtype, device) -> torch.Tensor:
    """Host array or tensor -> tensor of ``dtype`` on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    # convert on the host, so that only the target type's bytes are copied
    host = torch.empty(0, dtype=dtype).numpy().dtype
    return torch.as_tensor(np.ascontiguousarray(x, dtype=host),
                           device=device)


@dataclasses.dataclass
class PeelStats:
    """Work counters of one frontier-peel invocation.

    ``gathered`` counts incidence slots touched across all rounds; for a
    full decomposition it equals the incidence size 3T.
    """

    rounds: int          # sub-rounds executed (incl. frontier chunks)
    removed: int         # edges removed
    gathered: int        # incidence slots gathered
    max_frontier: int    # largest single-round frontier
    cap_f: int           # frontier buffer capacity used
    cap_t: int           # triangle gather capacity used
    resumes: int         # capacity-doubling resumes taken

    @classmethod
    def from_vec(cls, vec, cap_f, cap_t, resumes):
        vec = [int(v) for v in vec]
        return cls(vec[_S_ROUNDS], vec[_S_REMOVED], vec[_S_GATHERED],
                   vec[_S_MAXF], cap_f, cap_t, resumes)


# ---------------------------------------------------------------------------
# the frontier round primitive
# ---------------------------------------------------------------------------

def _frontier_round(alive, sup, rm, tris, tri_indptr, tri_ids, *,
                    cap_f: int, cap_t: int):
    """One compacted removal step: remove a prefix of ``rm``, repair ``sup``.

    Returns (alive2, sup2, rm_sub, nf, j_take, total_t, overflow), the last
    four as 0-d device tensors: ``rm_sub`` is the removed prefix of the
    frontier (edge-id order), ``nf`` the full frontier size, ``j_take`` the
    edges taken, ``total_t`` the incidence slots gathered; ``overflow`` is
    set when the frontier is non-empty but not even one edge's incidence
    row fits in ``cap_t``.
    """
    m = alive.shape[0]
    dev = alive.device
    rm_i = rm.to(torch.int64)
    nf = rm_i.sum()
    idx = torch.cumsum(rm_i, 0) - 1                 # frontier position
    tgt = torch.where(rm & (idx < cap_f), idx, cap_f)   # cap_f: dump slot
    f_ids = torch.full((cap_f + 1,), m, dtype=torch.int64, device=dev)
    f_ids = f_ids.scatter_(0, tgt, torch.arange(m, device=dev))[:cap_f]
    fc = f_ids.clamp(max=m - 1)
    lens = torch.where(f_ids < m, tri_indptr[fc + 1] - tri_indptr[fc], 0)
    offs = torch.cumsum(lens, 0)                    # inclusive prefix sums
    j_take = ((offs <= cap_t) & (f_ids < m)).sum()
    overflow = (nf > 0) & (j_take == 0)
    last = offs.index_select(0, (j_take - 1).clamp(min=0).reshape(1))[0]
    total_t = torch.where(j_take > 0, last, 0)
    rm_sub = rm & (idx < j_take)
    alive2 = alive & ~rm_sub

    # gather the incident triangles of the taken prefix (ragged -> flat)
    s = torch.arange(cap_t, device=dev)
    jc = torch.searchsorted(offs, s, right=True).clamp(max=cap_f - 1)
    valid = s < total_t
    pos = s - (offs[jc] - lens[jc])
    f = f_ids[jc]                                   # owning frontier edge
    slot = (tri_indptr[f.clamp(max=m - 1)] + pos).clamp(
        max=max(tri_ids.shape[0] - 1, 0))
    tid = tri_ids[slot]
    e = [tris[tid, c].clamp(max=m - 1) for c in range(3)]
    died = alive[e[0]] & alive[e[1]] & alive[e[2]]
    # a triangle incident to several removed edges appears once per such
    # edge; the smallest removed edge id owns it, so its survivors lose 1
    # exactly once
    owner = torch.minimum(
        torch.where(rm_sub[e[0]], e[0], BIG),
        torch.minimum(torch.where(rm_sub[e[1]], e[1], BIG),
                      torch.where(rm_sub[e[2]], e[2], BIG)))
    contribute = valid & died & (f == owner)
    dec = torch.zeros(m + 1, dtype=sup.dtype, device=dev)
    ones = torch.ones(cap_t, dtype=sup.dtype, device=dev)
    for e_c in e:
        dec.index_add_(0, torch.where(contribute & alive2[e_c], e_c, m), ones)
    return alive2, sup - dec[:m], rm_sub, nf, j_take, total_t, overflow


def _bump_stats(stats, nf, j_take, total_t):
    stats = stats + torch.stack(
        [torch.ones_like(nf), j_take, total_t, torch.zeros_like(nf)])
    stats[_S_MAXF] = torch.maximum(stats[_S_MAXF], nf)
    return stats


# ---------------------------------------------------------------------------
# frontier engine: host loops with capacity-doubling resume
# ---------------------------------------------------------------------------

def _default_caps(m: int, incidence, cap_f, cap_t):
    """Capacity heuristic: large rounds are chunked anyway, so capacities
    trade per-round gather width against sub-rounds; ``cap_t`` covers the
    largest incidence row unless set explicitly (a too-small explicit value
    is recovered by the doubling resume)."""
    indptr, tri_ids = incidence
    max_row = int((indptr[1:] - indptr[:-1]).max()) if m else 0
    n_inc = len(tri_ids)
    if cap_f is None:
        cap_f = _pow2_ceil(min(max(m, 1), max(256, m // 48)))
    if cap_t is None:
        cap_t = max(_pow2_ceil(min(max(n_inc, 1), max(1024, n_inc // 96))),
                    _pow2_ceil(max_row))
    return cap_f, cap_t


def _prep_incidence(tris, m, incidence):
    if incidence is None:
        incidence = triangle_incidence_np(np.asarray(tris), m)
    indptr, tri_ids = incidence
    if len(tri_ids) == 0:  # keep gather shapes non-empty
        tri_ids = np.zeros(1, np.int32)
    return np.asarray(indptr), np.asarray(tri_ids)


def _pick_engine(engine: str, tris, m: int, with_stats: bool) -> str:
    """"auto": the frontier engine for triangle-rich graphs (3T > m) or when
    stats are asked for, the dense engine otherwise."""
    if engine == "auto":
        if with_stats or 3 * int(np.asarray(tris).shape[0]) > m:
            return "frontier"
        return "dense"
    if engine not in ("frontier", "dense"):
        raise ValueError(f"unknown engine {engine!r}")
    return engine


def _frontier_inputs(tris, m, incidence, cap_f, cap_t, dev):
    indptr, tri_ids = _prep_incidence(tris, m, incidence)
    cap_f, cap_t = _default_caps(m, (indptr, tri_ids), cap_f, cap_t)
    return (_put(tris, torch.int64, dev), _put(indptr, torch.int64, dev),
            _put(tri_ids, torch.int64, dev), cap_f, cap_t)


def peel_classes(sup0, tris, edge_alive0, max_k=None, *, incidence=None,
                 cap_f=None, cap_t=None, with_stats=False, engine="auto",
                 device=None):
    """Trussness phi(e) of every edge.

    sup0: (m,) int32 initial supports; tris: (T, 3) triangle edge ids (rows
    on the drop slot m are inert); edge_alive0: (m,) bool.  ``max_k`` stops
    after the classes <= max_k (edges above keep phi 0 and stay alive).
    ``incidence`` may pass a precomputed ``triangle_incidence_np``.
    Host arrays or tensors in; returns (phi int32, alive bool) tensors on
    ``device``, plus a :class:`PeelStats` with ``with_stats`` (None for the
    dense engine).
    """
    dev = resolve_device(device)
    m = int(sup0.shape[0])
    if _pick_engine(engine, tris, m, with_stats) == "dense":
        phi, alive = peel_classes_dense(sup0, tris, edge_alive0,
                                        max_k=max_k, device=dev)
        return (phi, alive, None) if with_stats else (phi, alive)
    tris_d, indptr_d, tids_d, cap_f, cap_t = _frontier_inputs(
        tris, m, incidence, cap_f, cap_t, dev)
    alive = _put(edge_alive0, torch.bool, dev)
    sup = _put(sup0, torch.int32, dev)
    phi = torch.zeros(m, dtype=torch.int32, device=dev)
    stats = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    k, resumes = 2, 0
    while m:
        rm = alive & (sup <= k - 2)
        any_alive, any_rm, min_sup, ovf = host_read(
            alive.any(), rm.any(), torch.where(alive, sup, BIG).min(),
            overflow)
        if ovf:                      # no incidence row fit: double, resume
            cap_t *= 2
            resumes += 1
            overflow = torch.zeros_like(overflow)
        if not any_alive or (max_k is not None and k > max_k):
            break
        if any_rm:
            alive, sup, rm_sub, nf, j_take, total_t, overflow = \
                _frontier_round(alive, sup, rm, tris_d, indptr_d, tids_d,
                                cap_f=cap_f, cap_t=cap_t)
            phi = torch.where(rm_sub, k, phi)
            stats = _bump_stats(stats, nf, j_take, total_t)
        else:
            k = max(k + 1, min_sup + 2)
    if with_stats:
        return phi, alive, PeelStats.from_vec(stats.tolist(), cap_f, cap_t,
                                              resumes)
    return phi, alive


def peel_threshold(sup0, tris, alive0, removable, thresh, *, incidence=None,
                   cap_f=None, cap_t=None, with_stats=False, engine="auto",
                   device=None):
    """Single-level peel: repeatedly remove removable alive edges with
    ``sup <= thresh`` (repairing surviving supports) to a fixed point —
    Procedure 5 (thresh = k-2) and Procedure 8 (thresh = k-3).

    Returns (alive, sup, removed_mask) tensors — plus a PeelStats with
    ``with_stats``.
    """
    dev = resolve_device(device)
    m = int(sup0.shape[0])
    if _pick_engine(engine, tris, m, with_stats) == "dense":
        alive, sup, removed = peel_threshold_dense(
            sup0, tris, alive0, removable, thresh, device=dev)
        return (alive, sup, removed, None) if with_stats else \
            (alive, sup, removed)
    tris_d, indptr_d, tids_d, cap_f, cap_t = _frontier_inputs(
        tris, m, incidence, cap_f, cap_t, dev)
    alive0 = _put(alive0, torch.bool, dev)
    removable = _put(removable, torch.bool, dev)
    alive, sup = alive0, _put(sup0, torch.int32, dev)
    stats = torch.zeros(N_STATS, dtype=torch.int64, device=dev)
    overflow = torch.zeros((), dtype=torch.bool, device=dev)
    resumes = 0
    while True:
        rm = alive & removable & (sup <= thresh)
        any_rm, ovf = host_read(rm.any(), overflow)
        if ovf:
            cap_t *= 2
            resumes += 1
            overflow = torch.zeros_like(overflow)
        if not any_rm:
            break
        alive, sup, _, nf, j_take, total_t, overflow = _frontier_round(
            alive, sup, rm, tris_d, indptr_d, tids_d,
            cap_f=cap_f, cap_t=cap_t)
        stats = _bump_stats(stats, nf, j_take, total_t)
    removed = alive0 & ~alive
    if with_stats:
        return alive, sup, removed, PeelStats.from_vec(
            stats.tolist(), cap_f, cap_t, resumes)
    return alive, sup, removed


# ---------------------------------------------------------------------------
# dense engine — O(T) scatter work per round; baseline
# ---------------------------------------------------------------------------

def _tri_alive(alive_p, tris):
    return alive_p[tris[:, 0]] & alive_p[tris[:, 1]] & alive_p[tris[:, 2]]


def _dense_round(alive, sup, rm, tris):
    """Remove ``rm`` and repair ``sup`` by rescanning every triangle."""
    m = alive.shape[0]
    alive2 = alive & ~rm
    pad = torch.zeros(1, dtype=torch.bool, device=alive.device)
    alive_p, alive2_p = torch.cat([alive, pad]), torch.cat([alive2, pad])
    died = _tri_alive(alive_p, tris) & ~_tri_alive(alive2_p, tris)
    dec = torch.zeros(m + 1, dtype=sup.dtype, device=sup.device)
    for c in range(3):
        e = tris[:, c]
        dec.index_add_(0, e, (died & alive2_p[e]).to(sup.dtype))
    return alive2, sup - dec[:m]


def peel_classes_dense(sup0, tris, edge_alive0, max_k=None, *, device=None):
    """Dense-engine class peel (every round rescans the triangle list).
    Returns (phi int32, alive bool) tensors on ``device``."""
    dev = resolve_device(device)
    m = int(sup0.shape[0])
    tris = _put(tris, torch.int64, dev)
    alive = _put(edge_alive0, torch.bool, dev)
    sup = _put(sup0, torch.int32, dev)
    phi = torch.zeros(m, dtype=torch.int32, device=dev)
    k = 2
    while m:
        rm = alive & (sup <= k - 2)
        any_alive, any_rm, min_sup = host_read(
            alive.any(), rm.any(), torch.where(alive, sup, BIG).min())
        if not any_alive or (max_k is not None and k > max_k):
            break
        if any_rm:
            phi = torch.where(rm, k, phi)
            alive, sup = _dense_round(alive, sup, rm, tris)
        else:
            k = max(k + 1, min_sup + 2)
    return phi, alive


def peel_threshold_dense(sup0, tris, alive0, removable, thresh, *,
                         device=None):
    """Dense-engine single-level peel; returns (alive, sup, removed)."""
    dev = resolve_device(device)
    tris = _put(tris, torch.int64, dev)
    alive0 = _put(alive0, torch.bool, dev)
    removable = _put(removable, torch.bool, dev)
    alive, sup = alive0, _put(sup0, torch.int32, dev)
    while True:
        rm = alive & removable & (sup <= thresh)
        (any_rm,) = host_read(rm.any())
        if not any_rm:
            break
        alive, sup = _dense_round(alive, sup, rm, tris)
    return alive, sup, alive0 & ~alive


def support_from_triangles(tris, alive, m: int) -> torch.Tensor:
    """sup(e) = number of fully-alive triangles containing e (tensors on
    one device; rows on the drop slot m count as dead)."""
    pad = torch.zeros(1, dtype=torch.bool, device=alive.device)
    ta = _tri_alive(torch.cat([alive, pad]), tris).to(torch.int32)
    sup = torch.zeros(m + 1, dtype=torch.int32, device=alive.device)
    for c in range(3):
        sup.index_add_(0, tris[:, c], ta)
    return sup[:m]


def peel_recompute(tris, edge_alive0, *, device=None):
    """Global-iterate baseline (the MapReduce stand-in of the paper's Table
    4): every round recounts every support from the whole triangle list
    (:func:`support_from_triangles`), removes all the alive edges with
    ``sup <= k - 2``, or raises k to ``max(k + 1, min sup + 2)`` when none
    is.  Deliberately not frontier-compacted: its O(T) recount every round
    is what the comparison measures.  One ``host_read`` a round, and one
    more that finds no edge alive.

    Host arrays or tensors in (rows on the drop slot m are inert); returns
    phi (m,) int32 on ``device``.
    """
    dev = resolve_device(device)
    tris = _put(tris, torch.int64, dev)
    alive = _put(edge_alive0, torch.bool, dev)
    m = int(alive.shape[0])
    phi = torch.zeros(m, dtype=torch.int32, device=dev)
    k = 2
    while True:
        sup = support_from_triangles(tris, alive, m)
        rm = alive & (sup <= k - 2)
        any_alive, any_rm, min_sup = host_read(
            alive.any(), rm.any(), torch.where(alive, sup, BIG).min())
        if not any_alive:
            break
        if any_rm:
            phi = torch.where(rm, k, phi)
            alive = alive & ~rm
        else:
            k = max(k + 1, min_sup + 2)
    return phi


# ---------------------------------------------------------------------------
# batched local peels (out-of-core engine)
# ---------------------------------------------------------------------------

class PendingPeel:
    """Handle to one dispatched device peel.

    ``result()`` converts the device result to numpy once and caches it.
    The finalize handle is consumed before it runs: a failing ``result()``
    raises the original error once and poisons the handle; later calls
    raise a ``RuntimeError`` chained to that error.  ``new_compile`` is
    known at dispatch time (the shape-cache lookup).  ``fault_ctx``
    (optional) names the dispatch at the ``"finalize"`` fault site, which
    fires before the copy to the host and poisons the handle like a real
    device error would.
    """

    def __init__(self, finalize, new_compile: bool,
                 fault_ctx: Optional[dict] = None):
        self._finalize = finalize
        self.new_compile = bool(new_compile)
        self._fault_ctx = fault_ctx
        self._out = None
        self._error = None

    def result(self):
        if self._error is not None:
            raise RuntimeError(
                "PendingPeel finalize failed previously; it cannot be "
                "retried") from self._error
        if self._finalize is not None:
            finalize, self._finalize = self._finalize, None
            try:
                if self._fault_ctx is not None:
                    faults.check(faults.FINALIZE, **self._fault_ctx)
                self._out = finalize()
            except BaseException as e:
                self._error = e
                raise
        return self._out


def _note_shape(shape_cache, key) -> bool:
    """Add ``key`` to the caller's shape cache; True when it was new."""
    new = shape_cache is not None and key not in shape_cache
    if shape_cache is not None:
        shape_cache.add(key)
    return new


def peel_classes_batched(sup_b, tris_b, alive_b, *, shape_cache=None,
                         blocking=True, kernel: str = "auto", device=None,
                         fault_ctx: Optional[dict] = None):
    """Local trussness of every lane of one partition bucket.

    Host arrays in: (B, cap_e) sup / alive and (B, cap_t, 3) triangles in
    lane-local edge ids (padding rows on the drop slot cap_e).  The lanes
    peel in lockstep through the fused round kernel
    (``frontier_peel.ops.peel_classes_fused``); a triangle-free bucket
    short-cuts on the host (every alive edge peels at k = 2).  Only the
    rows up to each lane's last real row are uploaded, with that count per
    lane; padding rows before it are dropped by the first round.

    ``shape_cache`` is a caller-owned set of launch shapes; the result
    reports whether this call added one (the drivers' ``compiles``
    counter: the distinct launch shapes of a run).

    ``fault_ctx`` names this call at the ``"dispatch"`` fault site, checked
    before anything is uploaded, and its handle at ``"finalize"``; None (the
    default) skips both.

    Returns (phi (B, cap_e) int32, stats (B, N_STATS) int32, new_shape) as
    numpy when blocking, else a :class:`PendingPeel` yielding (phi, stats).
    """
    if fault_ctx is not None:
        faults.check(faults.DISPATCH, **fault_ctx)
    check_kernel(kernel)
    dev = resolve_device(device)
    tris_np = np.asarray(tris_b)
    cap_e = int(np.shape(sup_b)[1])
    if (tris_np[:, :, 0] >= cap_e).all():
        phi = np.where(np.asarray(alive_b), 2, 0).astype(np.int32)
        st = np.zeros((tris_np.shape[0], N_STATS), np.int32)
        pending = PendingPeel(lambda: (phi, st), False, fault_ctx)
    else:
        new = _note_shape(shape_cache, (tuple(np.shape(sup_b)),
                                        tuple(tris_np.shape)))
        # rows past a lane's last real row are padding: not uploaded
        real = (tris_np < cap_e).all(axis=2)
        n_rows = np.where(real.any(axis=1),
                          real.shape[1] - np.argmax(real[:, ::-1], axis=1), 0)
        phi_d, st_d = frontier_ops.peel_classes_fused(
            _put(sup_b, torch.int32, dev),
            _put(tris_np[:, :max(int(n_rows.max()), 1)], torch.int32, dev),
            _put(alive_b, torch.int32, dev), n_rows=_put(n_rows, torch.int32,
                                                         dev),
            cap_t=tris_np.shape[1], kernel=kernel)
        pending = PendingPeel(
            lambda: (phi_d.cpu().numpy(), st_d.cpu().numpy()), new,
            fault_ctx)
    if not blocking:
        return pending
    phi, st = pending.result()
    return phi, st, pending.new_compile


def local_threshold_peel(sup0, tris, removable, thresh, *, alive0=None,
                         shape_cache=None, blocking=True,
                         kernel: str = "auto", device=None,
                         fault_ctx: Optional[dict] = None):
    """Single-level peel of a compacted candidate subgraph on padded shapes.

    The per-k class extraction of both out-of-core drivers peels one
    candidate per k.  Its launch shape, for the ``compiles`` counter, is
    the pow4 capacities of edges and triangles, as in the reference; only
    the ``m`` edges and ``T`` triangle rows are uploaded (the round kernel
    needs no static shape).  All ``m`` edges start alive unless
    ``alive0`` masks some out (dead edges never enter the frontier and their
    triangles never repair supports; ``sup0`` must count fully-alive
    triangles only).  ``removable`` marks the internal/tentative edges.
    ``fault_ctx`` names the call at the ``"dispatch"`` and ``"finalize"``
    fault sites, as in :func:`peel_classes_batched`.  The round loop runs at
    dispatch, so a real device OOM surfaces here, not at finalize.

    Host arrays in; returns (alive_mask, removed_mask, new_shape) as numpy
    when blocking, else a :class:`PendingPeel` yielding the two masks.
    """
    if fault_ctx is not None:
        faults.check(faults.DISPATCH, **fault_ctx)
    check_kernel(kernel)
    dev = resolve_device(device)
    m, T = int(len(sup0)), int(len(tris))
    alive0 = (np.ones(m, bool) if alive0 is None
              else np.asarray(alive0, dtype=bool))
    removable = np.asarray(removable, bool) & alive0
    if T == 0:
        # no triangles: removals cascade nothing, one sweep is the fixpoint
        removed = removable & (np.asarray(sup0) <= thresh)
        alive_out = alive0 & ~removed
        pending = PendingPeel(lambda: (alive_out, removed), False, fault_ctx)
    else:
        new = _note_shape(shape_cache, (_pow4_ceil(max(m, 1)),
                                        _pow4_ceil(max(T, 1))))
        alive_dev = frontier_ops.peel_threshold_fused(
            _put(sup0, torch.int32, dev), _put(tris, torch.int32, dev),
            _put(removable, torch.int32, dev), int(thresh),
            _put(alive0, torch.int32, dev), kernel=kernel)

        def _finish():
            alive = alive_dev.cpu().numpy() > 0
            return alive, alive0 & ~alive

        pending = PendingPeel(_finish, new, fault_ctx)
    if not blocking:
        return pending
    alive, removed = pending.result()
    return alive, removed, pending.new_compile


# ---------------------------------------------------------------------------
# entry points
# ---------------------------------------------------------------------------

def estimate_working_set(g) -> int:
    """In-memory peel working set in int32 entries (routing heuristic):
    edge state (~4m) plus triangle list and incidence (6T), with T bounded
    by the oriented wedge count sum_a deg+(a)^2."""
    out_deg = (g.indptr[1:] - g.indptr[:-1]).astype(np.int64)
    return 4 * g.m + 6 * int((out_deg * out_deg).sum())


def truss_decompose(n: int, edges: np.ndarray, *, engine: str = "auto",
                    memory_budget=None, partitioner: str = "sequential",
                    partitioner_seed: int = 0, kernel: str = "auto",
                    with_stats: bool = False, device=None, mesh=None,
                    mesh_axes=None, checkpoint_dir=None, checkpoint_every=1,
                    resume: bool = False, max_retries: int = 2,
                    store=None, host_memory_budget=None, edits=None,
                    phi0=None):
    """End-to-end decomposition: phi (m,) int64 per canonical edge.

    ``engine``: "auto" (default) peels in memory (frontier or dense, see
    ``_pick_engine``), or routes to the batched bottom-up engine when
    ``memory_budget`` is given and ``estimate_working_set`` exceeds it;
    "frontier" / "dense" force an in-memory engine; "bottom-up" /
    "top-down" force an out-of-core engine, with a per-part budget of
    ``memory_budget`` working-set entries (default m // 8) and
    ``partitioner`` "sequential", "random" (reseeded per round from
    ``partitioner_seed``) or the triangle-aware "locality".

    ``checkpoint_dir`` journals the out-of-core engines' rounds and levels
    every ``checkpoint_every`` events (an int, or a duration such as
    ``"30s"``); ``resume=True`` continues from the newest intact snapshot,
    to the phi of an uninterrupted run.  ``max_retries`` bounds the
    lane-split retries a device OOM gets before the engine degrades to
    smaller rounds.  The in-memory engines run one peel and have nothing to
    journal: a ``checkpoint_dir`` routed to them warns and is ignored.

    ``store`` (a graph store of ``core.store``) keeps the out-of-core
    engines' working graph and triangle list off the host between rounds;
    ``host_memory_budget=`` (bytes, positive) alone builds a
    ``ChunkedDiskStore`` capped at that many bytes in a fresh temporary
    directory, which is closed and removed when the call returns.  Both
    change no result, add the store's counters to ``OocStats``, and warn
    and are ignored on the in-memory route.

    ``edits`` (a ``core.maintain.EditBatch`` or ``(op, u, v)`` sequence)
    routes the call through incremental maintenance instead: the pre-edit
    graph ``(n, edges)`` is decomposed with the same routing arguments, or
    its trussness taken from ``phi0`` (indexed by the canonical pre-edit
    edge list), and ``truss_maintain`` applies the edits.  The returned phi
    indexes the canonical post-edit edge list; ``store`` and the journal
    arguments go to the maintenance.  ``phi0`` without ``edits`` raises.

    ``kernel``: "auto" only — the fused round kernel on CUDA, its plain
    version on the CPU (out-of-core engines and maintenance; the in-memory
    engines have none).  ``device``: None means the CUDA card (raises
    without CUDA); pass "cpu" for the plain versions on the host.
    ``with_stats`` also returns a :class:`PeelStats` (frontier), None
    (dense) or an ``OocStats`` (out-of-core and maintenance).  ``mesh`` and
    ``mesh_axes`` are not ported yet and raise ``NotImplementedError``.
    """
    reject_unported(mesh=mesh, mesh_axes=mesh_axes)
    check_kernel(kernel)
    dev = resolve_device(device)
    if memory_budget is not None and memory_budget <= 0:
        raise ValueError(
            f"memory_budget must be a positive number of working-set "
            f"entries, got {memory_budget!r}")
    if host_memory_budget is not None and host_memory_budget <= 0:
        raise ValueError(
            f"host_memory_budget must be a positive byte count, got "
            f"{host_memory_budget!r}")
    if phi0 is not None and edits is None:
        raise ValueError("phi0= is only meaningful together with edits=")
    if edits is not None:
        from repro_torch.core.maintain import truss_maintain

        if phi0 is None:
            phi0 = truss_decompose(
                n, edges, engine=engine, memory_budget=memory_budget,
                partitioner=partitioner, partitioner_seed=partitioner_seed,
                kernel=kernel, max_retries=max_retries, device=dev)
        res = truss_maintain(
            (n, np.asarray(edges)), phi0, edits, kernel=kernel, store=store,
            checkpoint_dir=checkpoint_dir, checkpoint_every=checkpoint_every,
            resume=resume, device=dev)
        phi = np.asarray(res.phi, dtype=np.int64)
        return (phi, res.stats) if with_stats else phi
    g = build_graph(n, edges)
    if g.m == 0:
        phi = np.zeros(0, np.int64)
        return (phi, None) if with_stats else phi
    est = estimate_working_set(g)
    if engine == "auto" and memory_budget is not None and est > memory_budget:
        engine = "bottom-up"
    if engine in ("bottom-up", "top-down"):
        from repro_torch.core.bottom_up import bottom_up_decompose
        from repro_torch.core.top_down import top_down_decompose

        if memory_budget is not None:
            # working-set entries -> NS edge cost (sum of incident degrees)
            part_budget = max(64, (2 * g.m * memory_budget) // max(est, 1))
        else:
            part_budget = max(64, g.m // 8)
        with contextlib.ExitStack() as own:
            if store is None and host_memory_budget is not None:
                from repro_torch.core.store import ChunkedDiskStore

                tmp = own.enter_context(tempfile.TemporaryDirectory(
                    prefix="truss-store-"))
                store = own.enter_context(ChunkedDiskStore(
                    tmp, host_memory_budget=host_memory_budget))
            ooc = dict(partitioner=partitioner,
                       partitioner_seed=partitioner_seed, kernel=kernel,
                       device=dev, checkpoint_dir=checkpoint_dir,
                       checkpoint_every=checkpoint_every, resume=resume,
                       max_retries=max_retries, store=store)
            if engine == "bottom-up":
                res = bottom_up_decompose(n, edges, part_budget, **ooc)
            else:
                res = top_down_decompose(n, edges, budget=part_budget, **ooc)
        phi = np.asarray(res.phi).astype(np.int64)
        return (phi, res.stats) if with_stats else phi
    if checkpoint_dir is not None:
        warnings.warn(
            "checkpoint_dir is ignored by the in-memory engines (one peel, "
            "nothing to journal); pass a memory_budget that routes to an "
            "out-of-core engine, or engine='bottom-up'/'top-down'",
            stacklevel=2)
    if store is not None or host_memory_budget is not None:
        warnings.warn(
            "store=/host_memory_budget= are ignored by the in-memory "
            "engines (the whole graph is resident by construction); pass a "
            "memory_budget that routes to an out-of-core engine, or "
            "engine='bottom-up'/'top-down'",
            stacklevel=2)
    # the skew-aware listing: the same triangles as the reference's
    # list_triangles_np in another row order, which changes neither phi
    # nor PeelStats
    tris = list_triangles(g)
    sup = support_from_triangle_list(tris, g.m).astype(np.int32)
    if len(tris) == 0:
        tris = np.full((1, 3), g.m, np.int32)  # points at the drop slot
    out = peel_classes(sup, tris, np.ones(g.m, bool), engine=engine,
                       with_stats=with_stats, device=dev)
    phi = out[0].cpu().numpy().astype(np.int64)
    return (phi, out[2]) if with_stats else phi


def kmax_truss(n: int, edges: np.ndarray, *,
               device=None) -> tuple[int, np.ndarray]:
    """The k_max-truss: returns (k_max, its edge list)."""
    phi = truss_decompose(n, edges, device=device)
    if len(phi) == 0:
        return 2, np.zeros((0, 2), np.int32)
    edges = canonical_edges(edges, n)
    kmax = int(phi.max())
    return kmax, edges[phi == kmax]
