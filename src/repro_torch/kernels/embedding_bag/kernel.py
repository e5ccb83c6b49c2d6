"""Binding of the embedding-bag kernel (``csrc/embedding_bag.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/embedding_bag/kernel.py``
(``embedding_bag_kernel``): for each bag b the sum or mean over l of
``table[idx[b, l]]``, accumulated in float32 and returned in the table's
dtype.  Bound by bytes (the gathered rows); one thread per output element.
The TPU version pads D to 128 lanes; that is TPU layout and is dropped.

:func:`embedding_bag` launches the CUDA kernel on CUDA tensors and raises on
anything else; ``ops.embedding_bag`` chooses between it and the plain
version.  ``LAUNCHES`` counts the kernel launches.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
DTYPES = (torch.float32, torch.bfloat16)
MODES = ("sum", "mean")


def _lib() -> ctypes.CDLL:
    lib = build.library("embedding_bag")
    fn = lib.embedding_bag
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 4 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return lib


def check_args(table: torch.Tensor, idx: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"table must be (V, D) and idx (B, L), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "mean") -> torch.Tensor:
    """table: (V, D) float32 or bf16 CUDA tensor; idx: (B, L) int32/int64
    on the same card, every entry in [0, V).  Returns (B, D) in the
    table's dtype."""
    global LAUNCHES
    check_args(table, idx, mode)
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"the kernel takes CUDA tensors on one card, got "
                         f"table on {table.device}, idx on {idx.device}")
    if table.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bf16, got "
                        f"{table.dtype}")
    B, L = idx.shape
    D = table.shape[1]
    table = table.contiguous()
    idx = idx.to(torch.int32).contiguous()
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.embedding_bag(table.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), B, L, D, int(mode == "mean"),
                               int(table.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "embedding_bag")
    LAUNCHES += 1
    return out
