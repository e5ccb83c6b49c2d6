"""Binding of the fused frontier-peel round (``csrc/frontier_peel.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/frontier_peel/kernel.py``
(``fused_round``).  One thread per triangle row gathers its corners' pre-round
state and atomically decrements the surviving corners of a died triangle
into a separate buffer; an elementwise pass applies it.  The round is bound
by memory (see the source's header for the byte count).

:func:`fused_round` launches the CUDA kernel for CUDA tensors and takes the
plain version (``ref.fused_round``) for CPU tensors — nothing else.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.frontier_peel import ref

LAUNCHES = 0
_MAX_LANES = 65535          # grid y of the decrement launch


def _lib() -> ctypes.CDLL:
    lib = build.library("frontier_peel")
    fn = lib.frontier_peel_round
    fn.argtypes = [ctypes.c_void_p] * 7 + [
        ctypes.c_int, ctypes.c_int, ctypes.c_longlong, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


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


def fused_round(sup, alive, rm, tris):
    """One fused removal round over B lanes.

    sup/alive/rm: (B, E) int32 (alive, rm are 0/1 masks, rm within alive);
    tris: (B, T, 3) int32 with padding rows on the per-lane drop slot E.
    Returns (sup', alive') as new (B, E) int32 tensors.
    """
    global LAUNCHES
    _check(sup, alive, rm, tris)
    if sup.device.type == "cpu":
        return ref.fused_round(sup, alive, rm, tris)
    if sup.device.type != "cuda":
        raise ValueError(f"no kernel for device {sup.device}")
    B, E = sup.shape
    T = tris.shape[1]
    if B > _MAX_LANES:
        raise ValueError(f"at most {_MAX_LANES} lanes per launch, got {B}")
    sup, alive, rm, tris = (x.contiguous() for x in (sup, alive, rm, tris))
    dec = torch.zeros_like(sup)
    sup_out = torch.empty_like(sup)
    alive_out = torch.empty_like(sup)
    lib = _lib()
    with torch.cuda.device(sup.device):
        stream = torch.cuda.current_stream(sup.device).cuda_stream
        rc = lib.frontier_peel_round(
            sup.data_ptr(), alive.data_ptr(), rm.data_ptr(), tris.data_ptr(),
            dec.data_ptr(), sup_out.data_ptr(), alive_out.data_ptr(),
            B, E, T, stream)
    build.check(lib, rc, "frontier_peel_round")
    LAUNCHES += 1
    return sup_out, alive_out
