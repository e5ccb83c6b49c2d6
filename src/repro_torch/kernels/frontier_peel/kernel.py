"""Binding of the fused frontier-peel round (``csrc/frontier_peel.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/frontier_peel/kernel.py``
(``fused_round``).  One cooperative launch a round: an elementwise phase
writes sup', alive' and the pre-round state packed as two bit planes (E / 4
bytes a lane), then, after a grid-wide barrier, a block copies its lane's
state into shared memory and the lane's live triangle rows gather their
corners' state there, decrement the surviving corners of a dying triangle
(one atomic per distinct edge of a warp) and append the rows that stay live
to the other buffer of a ping-pong pair.  The round is bound by memory (see
the source's header for the byte count).

:func:`fused_round_live` is the live-row entry point the peel loops use;
:func:`fused_round` is the same round over every row (``n_rows = T``) with
the reference's signature.  Both launch the CUDA kernel for CUDA tensors
and take the plain version (``ref``) for CPU tensors — nothing else.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.frontier_peel import ref

LAUNCHES = 0
_FN = None


def _fn():
    """The C entry point, loaded and typed once."""
    global _FN
    if _FN is None:
        lib = build.library("frontier_peel")
        fn = lib.frontier_peel_live_round_launch
        fn.argtypes = [ctypes.c_void_p] * 10 + [
            ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_int,
            ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = (lib, fn)
    return _FN


def _check(sup, alive, rm, tris) -> None:
    if sup.dim() != 2:
        raise ValueError(f"sup must be (B, E), got {tuple(sup.shape)}")
    B, _ = sup.shape
    for name, x in (("alive", alive), ("rm", rm)):
        if x.shape != sup.shape:
            raise ValueError(f"{name} shape {tuple(x.shape)} != "
                             f"sup shape {tuple(sup.shape)}")
    if tris.dim() != 3 or tris.shape[0] != B or tris.shape[2] != 3:
        raise ValueError(f"tris must be (B, T, 3) with B={B}, got "
                         f"{tuple(tris.shape)}")
    for name, x in (("sup", sup), ("alive", alive), ("rm", rm),
                    ("tris", tris)):
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != sup.device:
            raise ValueError(f"{name} is on {x.device}, sup on {sup.device}")


def _check_rows(tris, n_rows, tris_out, n_rows_out) -> None:
    B = tris.shape[0]
    for name, x, shape in (("n_rows", n_rows, (B,)),
                           ("n_rows_out", n_rows_out, (B,)),
                           ("tris_out", tris_out, tuple(tris.shape))):
        if tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {shape}, got {tuple(x.shape)}")
        if x.dtype != torch.int32:
            raise TypeError(f"{name} must be int32, got {x.dtype}")
        if x.device != tris.device:
            raise ValueError(f"{name} is on {x.device}, tris on "
                             f"{tris.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if (tris.numel() and tris_out.data_ptr() == tris.data_ptr()) or \
            n_rows_out.data_ptr() == n_rows.data_ptr():
        raise ValueError("tris_out / n_rows_out must not alias tris / n_rows")


def fused_round_live(sup, alive, rm, tris, n_rows, tris_out, n_rows_out):
    """One fused removal round over the live rows of B lanes.

    sup/alive/rm: (B, E) int32 (alive, rm 0/1, rm within alive); tris:
    (B, T, 3) int32, of which lane b's rows [0, n_rows[b]) are read (ids E
    are the drop slot); n_rows: (B,) int32.  Writes the rows whose three
    corners are alive after the round into tris_out[b, :n_rows_out[b]] (in
    no fixed order on the card; rows beyond are left as they were) and
    their counts into n_rows_out.  Returns (sup', alive') as new (B, E)
    int32 tensors.
    """
    global LAUNCHES
    _check(sup, alive, rm, tris)
    _check_rows(tris, n_rows, tris_out, n_rows_out)
    if sup.device.type == "cpu":
        sup2, alive2, rows, cnt = ref.fused_round_live(sup, alive, rm, tris,
                                                       n_rows)
        tris_out.copy_(rows)
        n_rows_out.copy_(cnt)
        return sup2, alive2
    if sup.device.type != "cuda":
        raise ValueError(f"no kernel for device {sup.device}")
    if not tris.is_contiguous():
        raise ValueError("tris must be contiguous")
    B, E = sup.shape
    T = tris.shape[1]
    sup, alive, rm = (x.contiguous() for x in (sup, alive, rm))
    sup_out = torch.empty_like(sup)
    alive_out = torch.empty_like(sup)
    # the packed state: one {alive bits, rm bits} pair of words for every 32 edges
    words = torch.empty((B, (E + 31) // 32, 2), dtype=torch.int32,
                        device=sup.device)
    lib, fn = _fn()
    dev = sup.device.index
    if dev is None:
        dev = torch.cuda.current_device()
    rc = fn(sup.data_ptr(), alive.data_ptr(), rm.data_ptr(), tris.data_ptr(),
            n_rows.data_ptr(), sup_out.data_ptr(), alive_out.data_ptr(),
            words.data_ptr(), tris_out.data_ptr(), n_rows_out.data_ptr(), B,
            E, T, dev, torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, rc, "frontier_peel_live_round")
    LAUNCHES += 1
    return sup_out, alive_out


def fused_round(sup, alive, rm, tris):
    """One fused removal round over every row of B lanes.

    sup/alive/rm: (B, E) int32 (alive, rm are 0/1 masks, rm within alive);
    tris: (B, T, 3) int32 with padding rows on the per-lane drop slot E.
    Returns (sup', alive') as new (B, E) int32 tensors: the live-row round
    with ``n_rows = T``, its compacted rows discarded.
    """
    _check(sup, alive, rm, tris)
    B, T = tris.shape[0], tris.shape[1]
    tris = tris.contiguous()
    n_rows = torch.full((B,), T, dtype=torch.int32, device=tris.device)
    return fused_round_live(sup, alive, rm, tris, n_rows,
                            torch.empty_like(tris), torch.empty_like(n_rows))
