"""Binding of the dense triangle-count kernel (``csrc/triangle_count.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/triangle_count/kernel.py``
(``triangle_count_kernel``).  A tiled uint8 product with int32 ``__dp4a``
accumulation and a mask epilogue; bound by operations (2 n^3 int8 ops).

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
TILE = 64                   # the kernel's output tile and k step


def _lib() -> ctypes.CDLL:
    lib = build.library("triangle_count")
    fn = lib.triangle_count
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
                   ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def triangle_count(A: torch.Tensor) -> torch.Tensor:
    """S = (A @ A) o A for an (n, n) uint8 0/1 adjacency; (n, n) int32."""
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
        if Ap.data_ptr() % 16:          # the kernel loads 16-byte rows
            Ap = Ap.clone()
    S = torch.empty((n_pad, n_pad), dtype=torch.int32, device=A.device)
    lib = _lib()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream(A.device).cuda_stream
        rc = lib.triangle_count(Ap.data_ptr(), S.data_ptr(), n_pad, stream)
    build.check(lib, rc, "triangle_count")
    LAUNCHES += 1
    return S[:n, :n]
