"""Binding of the dense triangle-count kernel (``csrc/triangle_count.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/triangle_count/kernel.py``
(``triangle_count_kernel``).  A tiled product on the int8 tensor cores
(``wgmma`` m64n128k32, u8 operands, s32 accumulators, 128 x 128 output tiles,
128-byte k-slabs in a three-stage ``cp.async`` ring) with a mask epilogue;
bound by operations (2 n^3 int8 ops).  Int8 ``wgmma`` reads both operands
K-major, so the kernel takes the B operand from the rows of A^T: A's own
rows when the caller promises ``symmetric=True``, else a transposed copy
(one n^2-byte copy).

:func:`triangle_count` launches the CUDA kernel for CUDA tensors and takes
the plain version (``ref.support_dense``) for CPU tensors — nothing else.
``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build
from repro_torch.kernels.triangle_count import ref

LAUNCHES = 0
TILE = 128                  # the kernel's output tile and k-slab
_FN = None


def _fn():
    """The C entry point, loaded and typed once."""
    global _FN
    if _FN is None:
        lib = build.library("triangle_count")
        fn = lib.triangle_count
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _FN = (lib, fn)
    return _FN


def triangle_count(A: torch.Tensor, *, symmetric: bool = False
                   ) -> torch.Tensor:
    """S = (A @ A) o A for an (n, n) uint8 0/1 adjacency; (n, n) int32.

    ``symmetric=True`` promises A == A^T, so the kernel reads A's rows as
    the rows of A^T and no transposed copy is made; the result is A A^T o A
    otherwise.  The plain version (CPU tensors) computes A A o A.
    """
    global LAUNCHES
    if A.dim() != 2 or A.shape[0] != A.shape[1]:
        raise ValueError(f"adjacency must be square, got {tuple(A.shape)}")
    if A.dtype != torch.uint8:
        raise TypeError(f"adjacency must be uint8, got {A.dtype}")
    if A.device.type == "cpu":
        return ref.support_dense(A)
    if A.device.type != "cuda":
        raise ValueError(f"no kernel for device {A.device}")
    n = A.shape[0]
    n_pad = -(-n // TILE) * TILE
    if n_pad != n:
        Ap = torch.zeros((n_pad, n_pad), dtype=torch.uint8, device=A.device)
        Ap[:n, :n] = A
    else:
        Ap = A.contiguous()
        if Ap.data_ptr() % 16:          # the kernel copies 16-byte chunks
            Ap = Ap.clone()
    At = Ap if symmetric else Ap.t().contiguous()
    S = torch.empty((n_pad, n_pad), dtype=torch.int32, device=A.device)
    lib, fn = _fn()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = fn(Ap.data_ptr(), At.data_ptr(), S.data_ptr(), n_pad, stream)
    build.check(lib, rc, "triangle_count")
    LAUNCHES += 1
    return S[:n, :n]
