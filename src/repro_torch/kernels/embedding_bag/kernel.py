"""Binding of the embedding-bag kernel (``csrc/embedding_bag.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/embedding_bag/kernel.py``
(``embedding_bag_kernel``): for each bag b the sum or mean over l of
``table[idx[b, l]]``, accumulated in float32 and returned in the table's
dtype.  The TPU version pads D to 128 lanes; that is TPU layout and is
dropped.

Bound by bytes: the gathered rows, read at random addresses in whole 32-byte
sectors.  One warp per bag: the warp loads the bag's indices once, coalesced,
into shared memory (``STAGE`` at a time, the next group in flight with the
current rows), reads each row with the widest vector that divides the row's
bytes and the table's address (:func:`layout`), keeps eight row loads a
lane in flight, and combines its row groups' float32 sums by shuffles.
Within a row group the sum runs in bag order; row group r holds the rows
whose position in their group of ``STAGE`` is r modulo ``layout().rows``.

:func:`embedding_bag` launches the CUDA kernel on CUDA tensors and raises on
anything else; ``ops.embedding_bag`` chooses between it and the plain
version.  ``LAUNCHES`` counts the kernel launches.  :func:`gather_probe` is
a measuring tool, not a port kernel: it reads the same rows and indices
without the bags, and its time is the floor of the gather
(``chip_smoke.py`` prints it beside the kernel's).
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from repro_torch.kernels import build

LAUNCHES = 0
DTYPES = (torch.float32, torch.bfloat16)
MODES = ("sum", "mean")
# as in csrc/embedding_bag.cu: indices a warp stages at a time, and row
# loads a lane of the gather probe keeps in flight
STAGE = 128
UNROLL_PROBE = 16


class Layout(NamedTuple):
    """How a warp reads a row: ``vec`` bytes a load, ``chunks`` loads a row,
    ``rows`` rows a load instruction, ``passes`` over a row wider than 32
    loads."""
    vec: int
    chunks: int
    rows: int
    passes: int


def layout(D: int, itemsize: int, address: int = 0) -> Layout:
    """The kernel's layout for rows of D elements of ``itemsize`` bytes in a
    table at byte ``address``: the widest vector of 16, 8, 4 or 2 bytes that
    holds whole elements and divides the row and the address."""
    vec = next(w for w in (16, 8, 4, 2) if w >= itemsize
               and (D * itemsize) % w == 0 and address % w == 0)
    chunks = D * itemsize // vec
    return Layout(vec, chunks, 32 // chunks if chunks < 32 else 1,
                  -(-chunks // 32))


_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = build.library("embedding_bag")
    fn = lib.embedding_bag
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] + [
        ctypes.c_int] * 5 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    fn = lib.embedding_bag_probe
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_longlong] * 2 + [
        ctypes.c_int] * 3 + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    _LIB = lib
    return lib


def check_args(table: torch.Tensor, idx: torch.Tensor, mode: str) -> None:
    if mode not in MODES:
        raise ValueError(f"mode must be 'sum' or 'mean', got {mode!r}")
    if table.dim() != 2 or idx.dim() != 2:
        raise ValueError(f"table must be (V, D) and idx (B, L), got "
                         f"{tuple(table.shape)} and {tuple(idx.shape)}")
    if idx.dtype not in (torch.int32, torch.int64):
        raise TypeError(f"idx must be int32 or int64, got {idx.dtype}")


def _card_args(table: torch.Tensor, idx: torch.Tensor):
    if table.device.type != "cuda" or idx.device != table.device:
        raise ValueError(f"the kernel takes CUDA tensors on one card, got "
                         f"table on {table.device}, idx on {idx.device}")
    if table.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bf16, got "
                        f"{table.dtype}")
    return table.contiguous(), idx.to(torch.int32).contiguous()


def _layout(table: torch.Tensor) -> Layout:
    return layout(table.shape[1], table.element_size(), table.data_ptr())


def embedding_bag(table: torch.Tensor, idx: torch.Tensor, *,
                  mode: str = "mean") -> torch.Tensor:
    """table: (V, D) float32 or bf16 CUDA tensor; idx: (B, L) int32/int64
    on the same card, every entry in [0, V).  Returns (B, D) in the
    table's dtype."""
    global LAUNCHES
    check_args(table, idx, mode)
    table, idx = _card_args(table, idx)
    B, L = idx.shape
    D = table.shape[1]
    out = torch.empty((B, D), dtype=table.dtype, device=table.device)
    if B == 0 or D == 0:
        return out
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.embedding_bag(table.data_ptr(), idx.data_ptr(),
                               out.data_ptr(), B, L, D, int(mode == "mean"),
                               int(table.dtype == torch.bfloat16),
                               _layout(table).vec, stream)
    build.check(lib, rc, "embedding_bag")
    LAUNCHES += 1
    return out


def gather_probe(table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """The gather floor: reads ``table[idx]`` with the kernel's row layout
    and loads, without bags; returns one float32 a warp (the sum of the
    values it read).  Not counted in ``LAUNCHES``."""
    table, idx = _card_args(table, idx)
    n, D = idx.numel(), table.shape[1]
    if n == 0 or D == 0:
        return torch.zeros(1, dtype=torch.float32, device=table.device)
    lay = _layout(table)
    per_warp = lay.rows * UNROLL_PROBE
    out = torch.empty(-(-n // per_warp), dtype=torch.float32,
                      device=table.device)
    lib = _lib()
    with torch.cuda.device(table.device):
        stream = torch.cuda.current_stream(table.device).cuda_stream
        rc = lib.embedding_bag_probe(
            table.data_ptr(), idx.data_ptr(), out.data_ptr(), n, out.numel(),
            D, int(table.dtype == torch.bfloat16), lay.vec, stream)
    build.check(lib, rc, "embedding_bag_probe")
    return out
