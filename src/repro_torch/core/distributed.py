"""Distributed truss decomposition on ``torch.distributed`` (port of
``repro.core.distributed``).

The JAX package drives its mesh from one process: ``shard_map`` replicates
the edge state and splits lanes or triangle rows over named mesh axes.
Here every rank is a process that runs the same host driver on the same
inputs (SPMD).  The edge state the reference replicates is each rank's own
copy, only the device work is split, and the ranks meet in collectives.  A
mesh is a ``torch.distributed.device_mesh.DeviceMesh`` with the
reference's axis names (``"data"``, ``"tri"``); :func:`axis_size`,
:func:`axis_index` and :func:`axis_group` read it where the reference reads
``mesh.shape[name]``.

Pieces (the reference's, each round through the B1 kernel,
``kernels.frontier_peel``):

1. :func:`distributed_local_truss` — the parts stacked on each rank are
   peeled as lanes, with no communication; the results are gathered.
2. :func:`peel_classes_sharded` / :func:`local_threshold_peel_sharded` —
   one graph whose triangle rows are split over the ranks: every round
   each rank runs B1 over its own rows, and ONE sum all-reduce of the m
   decrements (:class:`RoundMerge`) keeps the replicated supports equal.
   B1 removes the whole frontier in a round, so the reference's frontier
   chunking (``cap_f``, the ``pmin`` on the chunk prefix) has no
   counterpart.
3. :func:`ring_support_dense` / :func:`allgather_support_dense` — S = (A @
   A) * A with A's rows split over the ranks: row blocks travel the ring
   (:func:`ring_shift`), or are all gathered at once.  The block products
   are plain matrix products, as in the reference.
4. :func:`peel_classes_batched_sharded` — one partition bucket's lanes
   split over the lane axis (no communication inside the peel), and with a
   (lane, tri) axis pair each lane's rows split over the second axis.

Every collective goes through :func:`all_reduce`, :func:`all_gather`,
:func:`ring_shift` or :func:`barrier`, which count their calls in
``COLLECTIVES``.  The tensors stay where they are: NCCL takes CUDA tensors,
and gloo (torch 2.11 on an H100) takes CUDA tensors for all four (the
backend stages them through the host), so two ranks can share one card.
They run at every mesh size: a one-rank mesh still runs them.  Ranks
agree on every dispatch's outcome (:func:`agree`): one MAX all-reduce of a
failure flag, so a failure on one rank raises on all of them and every
rank takes the same rung of a retry ladder.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.core import faults
from repro_torch.core.partition import round_up_to_multiple
from repro_torch.core.peel import _put, _upload_lanes
from repro_torch.core.support import _pow2_ceil, triangle_incidence_np
from repro_torch.device import host_read, resolve_device
from repro_torch.kernels.frontier_peel import ops as frontier_ops

COLLECTIVES = 0


class PeerFailure(RuntimeError):
    """Raised on the ranks whose own dispatch succeeded when another rank's
    failed.  Its message carries the retryable marker when the peer's
    failure was retryable, so ``faults.is_retryable`` gives every rank the
    same answer."""


# ---------------------------------------------------------------------------
# the mesh and the collectives
# ---------------------------------------------------------------------------

def _axes_tuple(axis) -> tuple:
    """Normalize an axis knob (one name or a sequence) to a tuple."""
    return (axis,) if isinstance(axis, str) else tuple(axis)


def axis_size(mesh, axis) -> int:
    """Ranks along ``axis`` (one name), or the product over several names."""
    size = 1
    for name in _axes_tuple(axis):
        size *= mesh.size(mesh.mesh_dim_names.index(name))
    return size


def mesh_devices(mesh, mesh_axis) -> int:
    """Devices a (mesh, mesh_axis) pair spans: 1 without a mesh."""
    return 1 if mesh is None else axis_size(mesh, mesh_axis)


def _flat(mesh, axes: tuple):
    """(group, index) of this rank over the flattened product of ``axes``
    (row-major, in the order named).  Every rank creates every slice's
    group in the same order (``new_group`` is collective over the world);
    the result is kept on the mesh."""
    cache = mesh.__dict__.setdefault("_flat_groups", {})
    if axes not in cache:
        dims = [mesh.mesh_dim_names.index(a) for a in axes]
        rest = [d for d in range(mesh.ndim) if d not in dims]
        ranks = mesh.mesh.permute(*rest, *dims).reshape(
            -1, axis_size(mesh, axes))
        me = dist.get_rank()
        for row in ranks.tolist():
            group = dist.new_group(row)
            if me in row:
                cache[axes] = (group, row.index(me))
    return cache[axes]


def axis_group(mesh, axis):
    """The process group of ``axis`` (one name), or of the flattened
    product of several names."""
    axes = _axes_tuple(axis)
    if len(axes) == 1:
        return mesh.get_group(axes[0])
    return _flat(mesh, axes)[0]


def axis_index(mesh, axis) -> int:
    """This rank's index along ``axis``, or over the flattened product."""
    axes = _axes_tuple(axis)
    if len(axes) == 1:
        return mesh.get_local_rank(axes[0])
    return _flat(mesh, axes)[1]


def mesh_group(mesh):
    """The group of every rank of the mesh."""
    return axis_group(mesh, tuple(mesh.mesh_dim_names))


def all_reduce(t: torch.Tensor, op: str, group) -> torch.Tensor:
    """``t`` reduced in place over ``group`` by ``op`` ("sum", "min" or
    "max")."""
    global COLLECTIVES
    COLLECTIVES += 1
    red = {"sum": dist.ReduceOp.SUM, "min": dist.ReduceOp.MIN,
           "max": dist.ReduceOp.MAX}[op]
    dist.all_reduce(t, red, group=group)
    return t


def all_gather(t: torch.Tensor, group) -> torch.Tensor:
    """Every rank's ``t`` concatenated along dim 0 in group order."""
    global COLLECTIVES
    COLLECTIVES += 1
    t = t.contiguous()
    parts = [torch.empty_like(t) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, t, group=group)
    return torch.cat(parts)


def ring_shift(t: torch.Tensor, group, step: int = 1) -> torch.Tensor:
    """The ring exchange that replaces ``ppermute``: ``t`` goes to the rank
    ``step`` places on in ``group`` (the next one by default; ``step=-1``:
    the previous one) and the block of the rank ``step`` places back comes
    back.  One ``all_to_all_single`` whose only non-empty splits are those
    two ranks: gloo has no pair from a rank to itself, so a one-rank ring of
    ``batch_isend_irecv`` could not run."""
    global COLLECTIVES
    COLLECTIVES += 1
    p = dist.get_world_size(group)
    me = dist.get_rank(group)
    src = t.contiguous().reshape(-1)
    out = torch.empty_like(src)
    send, recv = [0] * p, [0] * p
    send[(me + step) % p] = recv[(me - step) % p] = src.numel()
    dist.all_to_all_single(out, src, recv, send, group=group)
    return out.reshape(t.shape)


def barrier(group) -> None:
    global COLLECTIVES
    COLLECTIVES += 1
    dist.barrier(group=group)


def _flag_device(group) -> torch.device:
    """Where a small control tensor lives for ``group``'s backend."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def agree(err, group) -> None:
    """Agree on one dispatch's outcome over ``group``: one MAX all-reduce of
    this rank's flag (0 succeeded, 1 failed retryably, 2 failed otherwise).
    A failed rank re-raises its own error; the others raise
    :class:`PeerFailure`, retryable when the worst failure was."""
    mine = 0 if err is None else (1 if faults.is_retryable(err) else 2)
    flag = torch.tensor([mine], dtype=torch.int32,
                        device=_flag_device(group))
    worst = int(all_reduce(flag, "max", group)[0])
    if err is not None:
        raise err
    if worst == 1:
        raise PeerFailure("RESOURCE_EXHAUSTED: another rank's dispatch ran "
                          "out of memory")
    if worst == 2:
        raise PeerFailure("another rank's dispatch failed")


def rank0_decides(flag: bool, group) -> bool:
    """Rank 0's ``flag`` on every rank of ``group`` (one MAX all-reduce)."""
    mine = int(flag and dist.get_rank(group) == 0)
    t = torch.tensor([mine], dtype=torch.int32, device=_flag_device(group))
    return bool(all_reduce(t, "max", group)[0])


def agreement(mesh):
    """``agree`` over every rank of ``mesh``, as a handle's finalize
    callback."""
    group = mesh_group(mesh)
    return lambda err: agree(err, group)


def agreed(group, fn):
    """``fn()`` with its outcome agreed on over ``group`` (:func:`agree`):
    no collective may run inside ``fn``."""
    err = out = None
    try:
        out = fn()
    except Exception as e:
        err = e
    agree(err, group)
    return out


class RoundMerge:
    """The per-round merge of a triangle-sharded peel: runs this rank's
    round over its own rows and sums every rank's decrements with ONE
    all-reduce of the m int32 (two more slots count failed rounds, so a
    round that fails on one rank ends the peel on all of them instead of
    leaving the others in the next collective).  ``sup`` is the merged
    state after the last round; :meth:`error` gives the failure to agree
    on once the peel has returned."""

    def __init__(self, shape, device, group):
        n = int(np.prod(shape))
        self.group = group
        self.buf = torch.zeros(n + 2, dtype=torch.int32, device=device)
        self.failed = torch.zeros(2, dtype=torch.int32, device=device)
        self.err = None
        self.sup = None

    def __call__(self, sup, step):
        dec = self.buf[:-2].view(sup.shape)
        alive = None
        try:
            sup_loc, alive = step()
            torch.sub(sup, sup_loc, out=dec)
            self.buf[-2:] = 0
        except Exception as e:
            self.err = e
            self.buf.zero_()
            self.buf[-2 if faults.is_retryable(e) else -1] = 1
        all_reduce(self.buf, "sum", self.group)
        self.failed += self.buf[-2:]
        ok = self.buf[-2:].sum() == 0
        if alive is None:
            alive = torch.zeros_like(sup)
        # a failed round anywhere kills every edge: the loop ends at once
        self.sup = sup - dec
        return self.sup, alive * ok

    def error(self):
        """This rank's failure, a :class:`PeerFailure` for another rank's,
        or None (one host read)."""
        retryable, other = host_read(self.failed[0], self.failed[1])
        if self.err is not None:
            return self.err
        if other:
            return PeerFailure("another rank's round failed")
        if retryable:
            return PeerFailure("RESOURCE_EXHAUSTED: another rank's round "
                               "ran out of memory")
        return None


# ---------------------------------------------------------------------------
# host helpers (numpy, copied from the reference)
# ---------------------------------------------------------------------------

def pad_parts(parts: Sequence[tuple[np.ndarray, np.ndarray]],
              n_devices: int):
    """Stack per-part (sup, tris) into padded arrays with the part count a
    multiple of ``n_devices``: (sup_p, tris_p, alive_p, indptr_p, tids_p) of
    shapes (P, Em), (P, Tm, 3), (P, Em), (P, Em + 1), (P, Lm).  Padding
    edges are dead; padding triangles point at the per-part drop slot Em;
    (indptr_p, tids_p) is each part's edge -> triangle incidence CSR."""
    n_parts = len(parts)
    P_total = max(1, -(-n_parts // n_devices) * n_devices)
    Em = max([len(s) for s, _ in parts] + [1])
    Tm = max([len(t) for _, t in parts] + [1])
    Lm = max(1, 3 * Tm)
    sup_p = np.zeros((P_total, Em), np.int32)
    tris_p = np.full((P_total, Tm, 3), Em, np.int32)
    alive_p = np.zeros((P_total, Em), bool)
    indptr_p = np.zeros((P_total, Em + 1), np.int32)
    tids_p = np.zeros((P_total, Lm), np.int32)
    for i, (sup, tris) in enumerate(parts):
        sup_p[i, : len(sup)] = sup
        alive_p[i, : len(sup)] = True
        if len(tris):
            tris_p[i, : len(tris)] = tris
        indptr, tids = triangle_incidence_np(tris_p[i], Em)
        indptr_p[i] = indptr
        tids_p[i, : len(tids)] = tids
    return sup_p, tris_p, alive_p, indptr_p, tids_p


def _sharded_caps(m: int, indptr_s: np.ndarray, tids_s: np.ndarray,
                  cap_f=None, cap_t=None) -> tuple[int, int]:
    """The reference's frontier capacities of a triangle-sharded peel
    (``cap_t`` covers the largest per-shard incidence row).  B1 needs none;
    kept so that a caller of the reference's helpers finds it."""
    max_row = int((indptr_s[:, 1:] - indptr_s[:, :-1]).max()) if m else 1
    n_inc = tids_s.shape[1]
    if cap_f is None:
        cap_f = _pow2_ceil(min(max(m, 1), max(256, m // 16)))
    if cap_t is None:
        cap_t = _pow2_ceil(min(max(n_inc, 1),
                               max(max_row, 512, n_inc // 16)))
    return cap_f, max(cap_t, _pow2_ceil(max_row))


def shard_incidence(tris: np.ndarray, m: int, n_shards: int):
    """Per-shard edge -> triangle incidence over contiguous triangle shards
    (``tris`` (T_pad, 3) with T_pad divisible by ``n_shards``; triangle ids
    local to the shard).  Returns (indptr_s (S, m + 1), tids_s (S, L))
    padded to a common L."""
    t_loc = len(tris) // n_shards
    per = [triangle_incidence_np(tris[i * t_loc:(i + 1) * t_loc], m)
           for i in range(n_shards)]
    L = max([len(t) for _, t in per] + [1])
    indptr_s = np.zeros((n_shards, m + 1), np.int32)
    tids_s = np.zeros((n_shards, L), np.int32)
    for i, (indptr, tids) in enumerate(per):
        indptr_s[i] = indptr
        tids_s[i, : len(tids)] = tids
    return indptr_s, tids_s


def pad_triangles(tris: np.ndarray, m: int, multiple: int) -> np.ndarray:
    """``tris`` padded with drop-slot rows (id m) to a positive multiple of
    ``multiple`` rows."""
    t = len(tris)
    out = np.full((round_up_to_multiple(t, multiple), 3), m, np.int32)
    if t:
        out[:t] = tris
    return out


def pad_bucket_lanes(sup_b, tris_b, indptr_b, tids_b, alive_b,
                     n_lanes: int):
    """A bucket's lane dimension padded to ``n_lanes`` with dead lanes
    (alive False, sup 0, every row on the drop slot cap_e, empty
    incidence).  ``indptr_b`` / ``tids_b`` may be None (B1 reads no
    incidence); they stay None."""
    B, cap_e = sup_b.shape
    if n_lanes == B:
        return sup_b, tris_b, indptr_b, tids_b, alive_b
    pad = n_lanes - B
    return (
        np.concatenate([sup_b, np.zeros((pad, cap_e), np.int32)]),
        np.concatenate(
            [tris_b, np.full((pad,) + tris_b.shape[1:], cap_e, np.int32)]),
        None if indptr_b is None else np.concatenate(
            [indptr_b, np.zeros((pad, cap_e + 1), np.int32)]),
        None if tids_b is None else np.concatenate(
            [tids_b, np.zeros((pad, tids_b.shape[1]), np.int32)]),
        np.concatenate([alive_b, np.zeros((pad, cap_e), bool)]),
    )


def shard_incidence_lanes(tris_b: np.ndarray, cap_e: int, n_shards: int):
    """Lane-wise :func:`shard_incidence`: (indptr_ls (B, S, cap_e + 1),
    tids_ls (B, S, L)) over contiguous triangle shards of every lane,
    padded to a common L across lanes and shards."""
    B, T = tris_b.shape[0], tris_b.shape[1]
    t_loc = T // n_shards
    per = [[triangle_incidence_np(tris_b[b, i * t_loc:(i + 1) * t_loc],
                                  cap_e)
            for i in range(n_shards)] for b in range(B)]
    L = max([len(t) for row in per for _, t in row] + [1])
    indptr_ls = np.zeros((B, n_shards, cap_e + 1), np.int32)
    tids_ls = np.zeros((B, n_shards, L), np.int32)
    for b in range(B):
        for i, (indptr, tids) in enumerate(per[b]):
            indptr_ls[b, i] = indptr
            tids_ls[b, i, : len(tids)] = tids
    return indptr_ls, tids_ls


# ---------------------------------------------------------------------------
# the sharded peels
# ---------------------------------------------------------------------------

def _block(x, index: int, count: int):
    """Block ``index`` of ``count`` equal contiguous blocks of dim 0."""
    size = len(x) // count
    return x[index * size:(index + 1) * size]


def distributed_local_truss(mesh, sup_p, tris_p, alive_p, indptr_p, tids_p,
                            axis: str = "data", device=None):
    """Trussness of every part of :func:`pad_parts`'s stacks, the parts
    split over ``axis``: each rank peels its block as B1 lanes with no
    communication, and the blocks are gathered.  (``indptr_p`` / ``tids_p``
    are the reference engine's incidence; B1 reads the rows.)  Returns phi
    (P, Em) int32 on ``device`` on every rank."""
    dev = resolve_device(device)
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    lanes = [_block(np.asarray(x), i, n) for x in (sup_p, tris_p, alive_p)]

    def local():
        sup, tris, alive, n_rows = _upload_lanes(*lanes, dev)
        return frontier_ops.peel_classes_fused(sup, tris, alive,
                                               n_rows=n_rows)

    phi, _ = agreed(mesh_group(mesh), local)
    return all_gather(phi, axis_group(mesh, axis))


def _sharded_rounds(mesh, axis, sup0, tris, alive0, removable, thresh, dev,
                    before=None):
    """The triangle-sharded peel under both entry points: ``thresh`` None
    peels every class (phi), an int peels one level (alive).  Returns
    (result, merge); ``merge.sup`` is the replicated final support."""
    n, i = axis_size(mesh, axis), axis_index(mesh, axis)
    group, every = axis_group(mesh, axis), mesh_group(mesh)
    tris = np.asarray(tris)
    if len(tris) % n:
        raise ValueError(f"{len(tris)} triangle rows do not split over "
                         f"{n} ranks; pad them with pad_triangles")
    m = int(np.shape(sup0)[0])

    def upload():
        if before is not None:
            before()
        rows = _block(tris, i, n)
        real = (rows < m).all(axis=1)
        last = len(rows) - int(np.argmax(real[::-1])) if real.any() else 0
        n_rows = torch.tensor([last], dtype=torch.int32, device=dev)
        rows = _put(rows[:max(last, 1)], torch.int32, dev)
        rem = None if thresh is None else _put(removable, torch.int32, dev)
        return (_put(sup0, torch.int32, dev), rows,
                _put(alive0, torch.int32, dev), rem, n_rows,
                RoundMerge((1, m), dev, group))

    sup, rows, alive, rem, n_rows, merge = agreed(every, upload)
    if thresh is None:
        phi, _ = frontier_ops.peel_classes_fused(
            sup[None], rows[None], alive[None], n_rows=n_rows, merge=merge)
        out = phi[0]
    else:
        out = frontier_ops.peel_threshold_fused(
            sup, rows, rem, int(thresh), alive, n_rows=n_rows, merge=merge)
    agree(merge.error(), every)
    return out, merge


def peel_classes_sharded(mesh, sup0, tris, alive0, axis: str = "data",
                         device=None):
    """Trussness of one graph with its triangle rows split over ``axis``.

    ``tris`` (T, 3) must be padded to a multiple of the axis size
    (:func:`pad_triangles`; padding rows on the drop slot m).  Each rank
    runs B1 over its contiguous block of rows every round and the
    decrements are summed with one all-reduce of m int32, so sup / alive
    stay equal on every rank.  Host arrays or tensors in; returns phi (m,)
    int32 on ``device`` (None: the card) on every rank."""
    phi, _ = _sharded_rounds(mesh, axis, sup0, tris, alive0, None, None,
                             resolve_device(device))
    return phi


def local_threshold_peel_sharded(mesh, sup0, tris, alive0, removable,
                                 thresh, *, axis="data", device=None,
                                 before=None):
    """Single-level candidate peel with the triangle rows split over
    ``axis`` (one name, or several: their flattened product).

    The mesh form of ``peel.local_threshold_peel``'s level peel: sup /
    alive / removable replicated, ``tris`` (T, 3) a multiple of the shard
    count (padding rows on the drop slot m).  Every round each rank runs B1
    over its rows and one sum all-reduce merges the decrements.
    ``before`` runs first inside the dispatch whose outcome the ranks agree
    on (the drivers' fault check).  Returns the final alive mask (m,) bool
    on ``device`` on every rank."""
    alive, _ = _sharded_rounds(mesh, axis, sup0, tris, alive0, removable,
                               thresh, resolve_device(device), before)
    return alive > 0


def peel_classes_batched_sharded(mesh, sup_b, tris_b, alive_b, *,
                                 axis="data", device=None, before=None):
    """One bucket's lanes peeled across the mesh.

    The (B, ...) lane stacks are padded with dead lanes to a multiple of the
    lane axis (``axis`` or its first name; :func:`pad_bucket_lanes`) and
    split over it in contiguous blocks.  Each rank peels its block with B1
    to its fixed point; lanes are disjoint subproblems, so no collective
    runs inside the peel.  With ``axis`` a (lane, tri) pair each lane's rows
    (padded to a multiple of the tri axis) are split over the second axis,
    and a :class:`RoundMerge` over it keeps every lane's state equal on the
    ranks that share it.  ``before`` runs first inside the agreed dispatch.

    Returns device (phi (B, cap_e), stats (B, N_STATS)) of the caller's B
    lanes, gathered so that every rank holds the whole bucket.
    """
    dev = resolve_device(device)
    axes = _axes_tuple(axis)
    n_lane, i = axis_size(mesh, axes[0]), axis_index(mesh, axes[0])
    B, cap_e = np.shape(sup_b)
    T = int(np.shape(tris_b)[1])
    sup_p, tris_p, _, _, alive_p = pad_bucket_lanes(
        np.asarray(sup_b), np.asarray(tris_b), None, None,
        np.asarray(alive_b), round_up_to_multiple(B, n_lane))
    sup_p, tris_p, alive_p = (_block(x, i, n_lane)
                              for x in (sup_p, tris_p, alive_p))
    every = mesh_group(mesh)
    if len(axes) == 2:
        # each lane's rows padded to the tri axis; this rank's block of them
        n_tri, j = axis_size(mesh, axes[1]), axis_index(mesh, axes[1])
        t_pad = round_up_to_multiple(T, n_tri)
        tris_p = np.concatenate([tris_p, np.full(
            (len(tris_p), t_pad - T, 3), cap_e, np.int32)], axis=1)
        tris_p = tris_p[:, j * (t_pad // n_tri):(j + 1) * (t_pad // n_tri)]

    tri_group = None if len(axes) == 1 else axis_group(mesh, axes[1])

    def local():
        if before is not None:
            before()
        lanes = _upload_lanes(sup_p, tris_p, alive_p, dev)
        if tri_group is None:
            # no collective inside the peel: the whole of it is agreed on
            return frontier_ops.peel_classes_fused(
                *lanes[:3], n_rows=lanes[3], cap_t=T)
        return lanes, RoundMerge(sup_p.shape, dev, tri_group)

    if tri_group is None:
        phi, st = agreed(every, local)
    else:
        (sup, tris, alive, n_rows), merge = agreed(every, local)
        phi, st = frontier_ops.peel_classes_fused(
            sup, tris, alive, n_rows=n_rows, cap_t=T, merge=merge)
        agree(merge.error(), every)
    group = axis_group(mesh, axes[0])
    return all_gather(phi, group)[:B], all_gather(st, group)[:B]


# ---------------------------------------------------------------------------
# dense supports
# ---------------------------------------------------------------------------

def _row_block(mesh, A, axis, device):
    p, i = axis_size(mesh, axis), axis_index(mesh, axis)
    n = int(np.shape(A)[0])
    if n % p:
        raise ValueError(f"n = {n} does not split over {p} ranks")
    return _put(_block(A, i, p), torch.float32, resolve_device(device)), p, i


def ring_support_dense(mesh, A, axis: str = "data", device=None):
    """S = (A @ A) * A with A's rows split over ``axis``, the row blocks
    passed around the ring: at step s a rank multiplies the columns of its
    rows that belong to block (i - s) mod p by that block, then passes the
    block on (:func:`ring_shift`).  A: (n, n) 0/1, n a multiple of the axis
    size.  Returns S (n, n) float32 on ``device`` on every rank."""
    a_loc, p, i = _row_block(mesh, A, axis, device)
    nb = a_loc.shape[0]
    group = axis_group(mesh, axis)
    blk, acc = a_loc, torch.zeros_like(a_loc)
    for step in range(p):
        src = (i - step) % p
        acc += a_loc[:, src * nb:(src + 1) * nb] @ blk
        blk = ring_shift(blk, group)
    return all_gather(acc * a_loc, group)


def allgather_support_dense(mesh, A, axis: str = "data", device=None):
    """:func:`ring_support_dense`'s S by one all-gather of the row blocks
    (the reference's baseline schedule)."""
    a_loc, _, _ = _row_block(mesh, A, axis, device)
    group = axis_group(mesh, axis)
    return all_gather((a_loc @ all_gather(a_loc, group)) * a_loc, group)
