"""Outer peel loops over the fused round kernel.

``peel_classes_fused`` and ``peel_threshold_fused`` are the lockstep loops of
``repro.kernels.frontier_peel.ops``: per round, one ``kernel.fused_round_live``
call plus a few tensor reductions for the per-lane k-jump.  JAX runs them as
one ``lax.while_loop`` on the device; here they are host loops over device
tensors with ONE host synchronisation per round (``device.host_read`` of the
loop-control flags).  The loops hold two row buffers and their per-lane
counts for the whole peel and swap them every round: a round reads only the
rows still live after the last one (the first round drops the padding) and
writes the survivors into the other buffer; the counts stay on the device.
A round in which no lane removes an edge is a no-op for the round kernel, so
its launch is skipped; the stats are identical to the reference's.

Both loops take an optional ``merge`` (``core.distributed.RoundMerge``): a
rank that holds only a shard of the triangle rows hands it each round, and
it runs the round and sums the decrements of every rank of its group, so
the replicated edge state stays equal on all of them.

The reference's routing rule for ``kernel="auto"`` (TPU backend, VMEM
budget, 3T >= E) does not carry over: here ``"auto"`` means the CUDA kernel
for CUDA tensors and the plain version for CPU tensors.
"""

from __future__ import annotations

import torch

from repro_torch.device import host_read
from repro_torch.kernels import check_kernel
from repro_torch.kernels.frontier_peel import kernel as fk
from repro_torch.kernels.frontier_peel.ref import BIG

# stats columns (also core.peel's PeelStats vector): rounds, edges removed,
# incidence slots gathered, max single-round frontier
N_STATS = 4
_S_ROUNDS, _S_REMOVED, _S_GATHERED, _S_MAXF = range(N_STATS)


class _Rows:
    """A ping-pong pair of (B, T, 3) row buffers with their (B,) counts.

    The first round reads the caller's rows and counts; they are never
    written: the pair's second buffer takes their place after it."""

    def __init__(self, tris, n_rows):
        B, T = tris.shape[0], tris.shape[1]
        if n_rows is None:
            n_rows = torch.full((B,), T, dtype=torch.int32,
                                device=tris.device)
        self.tris = [tris.contiguous(), torch.empty_like(tris)]
        self.cnt = [n_rows.to(device=tris.device, dtype=torch.int32),
                    torch.empty((B,), dtype=torch.int32, device=tris.device)]
        self.first = True

    def round(self, sup, alive, rm):
        """One round over the live rows; the survivors become the live
        rows."""
        out = fk.fused_round_live(sup, alive, rm, self.tris[0], self.cnt[0],
                                  self.tris[1], self.cnt[1])
        if self.first:
            self.first = False
            self.tris[0] = torch.empty_like(self.tris[1])
            self.cnt[0] = torch.empty_like(self.cnt[1])
        self.tris.reverse()
        self.cnt.reverse()
        return out


def peel_classes_fused(sup_b, tris_b, alive_b, *, n_rows=None, cap_t=None,
                       kernel: str = "auto", merge=None):
    """Trussness of every lane by lockstep fused rounds.

    sup_b/alive_b: (B, E) int32 tensors, tris_b: (B, T, 3) int32 on the same
    device (padding rows on the drop slot E).  ``n_rows`` (B,) gives each
    lane's row count (rows past it are never read), default T.  ``cap_t`` is
    the triangle capacity the stats count, default T.  ``merge(sup, step)``
    runs each round (``step``) and returns the merged (sup, alive).  Returns
    (phi (B, E) int32, stats (B, N_STATS) int32): per lane, rounds += 1
    while the lane is alive, removed += frontier size, gathered += 3 cap_t
    on rounds that remove, max frontier.
    """
    check_kernel(kernel)
    sup, alive = sup_b, alive_b
    B, E = sup.shape
    three_t = 3 * int(tris_b.shape[1] if cap_t is None else cap_t)
    dev = sup.device
    rows = _Rows(tris_b, n_rows)
    phi = torch.zeros((B, E), dtype=torch.int32, device=dev)
    k = torch.full((B,), 2, dtype=torch.int32, device=dev)
    st = torch.zeros((B, N_STATS), dtype=torch.int32, device=dev)
    while True:
        rm = torch.where(sup <= k[:, None] - 2, alive, 0)
        nf = rm.sum(dim=1, dtype=torch.int32)
        has_rm = nf > 0
        lane_alive = (alive > 0).any(dim=1)
        any_alive, any_rm = host_read(lane_alive.any(), has_rm.any())
        if not any_alive:
            break
        min_sup = torch.where(alive > 0, sup, BIG).amin(dim=1)
        k_next = torch.where(lane_alive & ~has_rm,
                             torch.maximum(k + 1, min_sup + 2), k)
        phi = torch.where(rm > 0, k[:, None], phi)
        if any_rm:
            sup, alive = _round(rows, sup, alive, rm, merge)
        st[:, _S_ROUNDS] += lane_alive.to(torch.int32)
        st[:, _S_REMOVED] += nf
        st[:, _S_GATHERED] += torch.where(has_rm, three_t, 0).to(torch.int32)
        st[:, _S_MAXF] = torch.maximum(st[:, _S_MAXF], nf)
        k = k_next
    return phi, st


def peel_threshold_fused(sup, tris, removable, thresh: int, alive0, *,
                         n_rows=None, kernel: str = "auto", merge=None):
    """Single-level candidate peel by fused rounds: repeatedly remove the
    removable alive edges with ``sup <= thresh``.  (E,) int32 sup /
    removable / alive0 and (T, 3) int32 triangles on one device, of which
    the first ``n_rows`` (a (1,) int32 tensor, default T) are read;
    ``merge`` as in :func:`peel_classes_fused`.  Returns the final (E,)
    int32 alive mask."""
    check_kernel(kernel)
    sup, alive = sup[None], alive0[None]
    rows = _Rows(tris[None], n_rows)
    rem = removable[None] > 0
    while True:
        rm = torch.where(rem & (sup <= thresh), alive, 0)
        (any_rm,) = host_read(rm.any())
        if not any_rm:
            return alive[0]
        sup, alive = _round(rows, sup, alive, rm, merge)


def _round(rows, sup, alive, rm, merge):
    """One round over the live rows, merged across ranks by ``merge``."""
    if merge is None:
        return rows.round(sup, alive, rm)
    return merge(sup, lambda: rows.round(sup, alive, rm))
