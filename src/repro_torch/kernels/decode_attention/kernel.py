"""Binding of the decode-attention kernel, B5 (``csrc/decode_attention.cu``).

Replaces no TPU kernel: the JAX package's decode attention
(``src/repro/models/transformer.py``, ``_decode_attention``) is plain jnp.
It was added because the port's float32 copies of the cache in the same
arithmetic held 86 % of a decode step's device time (``PERF.md``).  One new
query token a row attends over that row's cache, positions
``[pos - window + 1, pos]`` (or ``[0, pos]``), in float32 with an online
softmax, and the output is rounded once to the query's dtype.  Bound by
bytes (each visible cache value read once); the source's header says what
the design does about it.

:func:`decode_attention` launches the kernel on CUDA tensors and raises on
anything else; ``ops.decode_attention`` chooses between it and the plain
version.  :func:`split_plan` sets how many blocks share a (row, kv head)
pair's positions, from the shape alone; with more than one a second launch
combines them.  ``LAUNCHES`` counts the launches of both.  :func:`smem_bytes`
is checked against ``build.SMEM_BUDGET_BYTES``.
"""

from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import build

LAUNCHES = 0
DTYPES = (torch.float32, torch.bfloat16)
MAX_D = 256                 # head dimensions: multiples of 8 up to this
MAX_GROUP = 8               # query heads a kv head
# as in csrc/decode_attention.cu: warps a block, cp.async stages a warp,
# position rows a lane loads a stage, bytes a load, values of a row a lane
WARPS, STAGES, UNROLL, VEC_BYTES, VALS = 4, 4, 2, 16, 8
STATIC_SMEM_BYTES = 0
# the split: blocks the card should hold at once (SMs x this), and the fewest
# positions a split takes
BLOCKS_PER_SM = 4
MIN_SPLIT_POSITIONS = 128
H100_SMS = 132

_LIB = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = build.library("decode_attention")
    fn = lib.decode_attention
    fn.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 8 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.decode_attention_smem_bytes.argtypes = [ctypes.c_int] * 3
    lib.decode_attention_smem_bytes.restype = ctypes.c_int
    _LIB = lib
    return lib


def group_bucket(g: int) -> int:
    """The query heads a kernel instantiation holds (1, 2, 4 or 8) for a
    group of ``g``."""
    return 1 if g <= 1 else 2 if g <= 2 else 4 if g <= 4 else 8


def lanes_log2(d: int) -> int:
    """log2 of the lanes that hold one position's row of a head: the power
    of two at or above d / 8 (a lane holds 8 values)."""
    return max(0, math.ceil(math.log2(-(-d // VALS))))


def smem_bytes(d: int, g: int, dtype: torch.dtype) -> int:
    """Shared memory of one block at head dimension ``d`` and group ``g``,
    in bytes (all of it dynamic): the larger of the warps' cp.async rings
    (K and V, ``STAGES`` x ``UNROLL`` rows of 16-byte vectors a lane, two a
    float32 lane) and the float32 accumulators, maxima and sums of the
    warps' combine, which reuses them.  Mirrors the source's
    ``decode_attention_smem_bytes``."""
    vecs = 1 if dtype == torch.bfloat16 else 2
    ring = WARPS * STAGES * UNROLL * 2 * vecs * 32 * VEC_BYTES
    merge = WARPS * group_bucket(g) * (d + 2) * 4
    return STATIC_SMEM_BYTES + max(ring, merge)


def c_smem_bytes(d: int, g: int, dtype: torch.dtype) -> int:
    """The source's ``decode_attention_smem_bytes(d, g, bf16)`` (builds the
    library on first use)."""
    return _lib().decode_attention_smem_bytes(d, g,
                                              int(dtype == torch.bfloat16))


def split_plan(pairs: int, span: int, sms: int = H100_SMS) -> int:
    """Blocks that share one (row, kv head) pair's positions, from the shape
    alone: 1 when the ``pairs`` already fill ``BLOCKS_PER_SM`` blocks an SM,
    else enough splits to fill them, at most one per ``MIN_SPLIT_POSITIONS``
    of the longest visible ``span`` (the cache's length, or the window)."""
    target = sms * BLOCKS_PER_SM
    if pairs >= target:
        return 1
    return max(1, min(-(-target // pairs), -(-span // MIN_SPLIT_POSITIONS)))


def check_args(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
               pos: torch.Tensor, window: int | None) -> int:
    """Validate the kernel's inputs; return the GQA group.  q: (B, 1, Hq,
    D); ck, cv: (B, S, Hkv, D), contiguous; pos: (B,) int32; all of one
    float dtype (float32 or bf16), D a multiple of 8 up to ``MAX_D``, Hq a
    multiple of Hkv at most ``MAX_GROUP`` times it, window positive or
    None."""
    if q.dim() != 4 or q.shape[1] != 1 or ck.dim() != 4 or \
            cv.shape != ck.shape or pos.shape != (q.shape[0],):
        raise ValueError(f"q must be (B, 1, Hq, D), ck and cv (B, S, Hkv, D) "
                         f"and pos (B,), got {tuple(q.shape)}, "
                         f"{tuple(ck.shape)}, {tuple(cv.shape)}, "
                         f"{tuple(pos.shape)}")
    b, _, hq, d = q.shape
    hkv = ck.shape[2]
    if ck.shape[0] != b or ck.shape[3] != d or min(ck.shape[1:3]) < 1:
        raise ValueError(f"the cache {tuple(ck.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dimension")
    if hq % hkv or hq // hkv > MAX_GROUP:
        raise ValueError(f"q heads must be 1 to {MAX_GROUP} times the kv "
                         f"heads, got hq={hq}, hkv={hkv}")
    if d % VALS or not VALS <= d <= MAX_D:
        raise ValueError(f"the kernel takes a head dimension that is a "
                         f"multiple of {VALS} up to {MAX_D}, got {d}")
    if q.dtype not in DTYPES or ck.dtype != q.dtype or cv.dtype != q.dtype:
        raise TypeError(f"q, ck and cv must share one dtype, float32 or "
                        f"bf16, got {q.dtype}, {ck.dtype}, {cv.dtype}")
    if pos.dtype != torch.int32:
        raise TypeError(f"pos must be int32, got {pos.dtype}")
    for name, x in (("q", q), ("ck", ck), ("cv", cv), ("pos", pos)):
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous, got strides "
                             f"{tuple(x.stride())} for shape "
                             f"{tuple(x.shape)}")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    return hq // hkv


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, window: int | None = None
                     ) -> torch.Tensor:
    """q: (B, 1, Hq, D); ck, cv: (B, S, Hkv, D), the layer's cache as
    stored; pos: (B,) int32, each row's position (in [0, S)); CUDA tensors
    on one card (:func:`check_args`).  Returns (B, 1, Hq, D) in q's
    dtype."""
    global LAUNCHES
    g = check_args(q, ck, cv, pos, window)
    for name, x in (("q", q), ("ck", ck), ("cv", cv), ("pos", pos)):
        if x.device.type != "cuda" or x.device != q.device:
            raise ValueError(f"{name} is on {x.device}: the kernel takes "
                             f"CUDA tensors on one card")
        if name != "pos" and x.data_ptr() % VEC_BYTES:
            raise ValueError(f"{name}: the kernel needs a {VEC_BYTES}-byte "
                             f"aligned base pointer, got address "
                             f"{x.data_ptr()}")
    b, _, _, d = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    if smem_bytes(d, g, q.dtype) > build.SMEM_BUDGET_BYTES:
        raise ValueError(f"a block needs {smem_bytes(d, g, q.dtype)} bytes "
                         f"of shared memory, over the "
                         f"{build.SMEM_BUDGET_BYTES}-byte budget")
    out = torch.empty_like(q)
    if b == 0:
        return out
    sms = torch.cuda.get_device_properties(q.device).multi_processor_count
    nsplit = split_plan(b * hkv, s if window is None else min(s, window),
                        sms)
    part = None
    if nsplit > 1:
        part = torch.empty(b * hkv * nsplit * g * (d + 2),
                           dtype=torch.float32, device=q.device)
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.decode_attention(
            q.data_ptr(), ck.data_ptr(), cv.data_ptr(), pos.data_ptr(),
            out.data_ptr(), None if part is None else part.data_ptr(), b, s,
            hkv, g, d, 0 if window is None else int(window), nsplit,
            lanes_log2(d), 1.0 / math.sqrt(d),
            int(q.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "decode_attention")
    LAUNCHES += 1 if nsplit == 1 else 2
    return out
