"""Plain PyTorch versions of the fused frontier-peel round and class peel.

``fused_round`` states the round's semantics with gathers and a scatter-add
(no tiling, no atomics); ``fused_round_live`` is the same round over the
first ``n_rows`` rows of each lane, with the rows that stay live compacted
in order.  The CUDA kernel (``kernel.fused_round_live`` on a CUDA tensor)
must equal them exactly (its compacted rows as a multiset), and CPU tensors
take them instead of the kernel.  ``peel_classes`` runs the lockstep class
peel on top of ``fused_round``.
"""

from __future__ import annotations

import torch

BIG = (1 << 30) - 1   # "no alive edge" sentinel of the k-jump min


def _pad_drop(x: torch.Tensor) -> torch.Tensor:
    """Append the per-lane drop slot (id E) that padding rows target."""
    return torch.cat([x, x.new_zeros(x.shape[0], 1)], dim=1)


def fused_round(sup, alive, rm, tris):
    """One removal round over B lanes.

    sup/alive/rm: (B, E) int32 (alive, rm 0/1, rm within alive); tris:
    (B, T, 3) int32 with padding rows on the drop slot E.  A triangle dies
    when all corners were alive and >= 1 was removed; each died triangle
    decrements each of its surviving corners once.  Returns (sup', alive')
    as (B, E) int32.
    """
    B, E = sup.shape
    idx = tris.long()
    alive_p, rm_p = _pad_drop(alive), _pad_drop(rm)
    a = [torch.gather(alive_p, 1, idx[:, :, c]) for c in range(3)]
    r = [torch.gather(rm_p, 1, idx[:, :, c]) for c in range(3)]
    died = a[0] * a[1] * a[2] * (1 - (1 - r[0]) * (1 - r[1]) * (1 - r[2]))
    alive2 = alive * (1 - rm)
    alive2_p = _pad_drop(alive2)
    dec = torch.zeros((B, E + 1), dtype=sup.dtype, device=sup.device)
    for c in range(3):
        tgt = idx[:, :, c]
        dec.scatter_add_(1, tgt, died * torch.gather(alive2_p, 1, tgt))
    return sup - dec[:, :E], alive2


def fused_round_live(sup, alive, rm, tris, n_rows):
    """The round over rows [0, n_rows[b]) of each lane b, and the rows that
    stay live.

    Rows past a lane's count are read as padding.  A row stays live when its
    three corners are alive after the round (a drop-slot corner never is).
    Returns (sup', alive', rows (B, T, 3), counts (B,) int32): lane b's live
    rows in their input order in rows[b, :counts[b]], the drop slot E after.
    """
    B, E = sup.shape
    T = tris.shape[1]
    t = torch.arange(T, device=tris.device)
    in_rows = t[None, :] < n_rows.to(torch.int64).clamp(0, T)[:, None]
    rows = torch.where(in_rows[:, :, None], tris, E)
    sup2, alive2 = fused_round(sup, alive, rm, rows)
    alive2_p = _pad_drop(alive2)
    idx = rows.long()
    live = in_rows
    for c in range(3):
        live = live & (torch.gather(alive2_p, 1, idx[:, :, c]) > 0)
    # order-keeping compaction: live rows first, by row index
    order = torch.argsort(torch.where(live, t, T + t), dim=1, stable=True)
    counts = live.sum(dim=1, dtype=torch.int32)
    packed = torch.gather(rows, 1, order[:, :, None].expand(B, T, 3))
    packed = torch.where((t[None, :] < counts[:, None])[:, :, None], packed, E)
    return sup2, alive2, packed, counts


def peel_classes(sup0, tris, alive0):
    """Trussness of every lane by lockstep plain rounds (host loop).

    sup0/alive0: (B, E) int32; tris: (B, T, 3) int32.  Returns phi (B, E)
    int32 — the fixed point of the class peel restricted to the alive mask.
    """
    sup, alive = sup0, alive0
    B, E = sup.shape
    phi = torch.zeros((B, E), dtype=torch.int32, device=sup.device)
    k = torch.full((B,), 2, dtype=torch.int32, device=sup.device)
    while bool((alive > 0).any()):
        rm = alive * (sup <= k[:, None] - 2).to(alive.dtype)
        lane_alive = alive.sum(dim=1) > 0
        has_rm = rm.sum(dim=1) > 0
        min_sup = torch.where(alive > 0, sup, BIG).amin(dim=1)
        jump = torch.maximum(k + 1, min_sup + 2)
        k_next = torch.where(lane_alive & ~has_rm, jump, k)
        phi = torch.where(rm > 0, k[:, None], phi)
        sup, alive = fused_round(sup, alive, rm, tris)
        k = k_next
    return phi
