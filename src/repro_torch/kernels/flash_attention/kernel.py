"""Binding of the flash-attention kernel (``csrc/flash_attention.cu``).

Replaces the Pallas TPU kernel ``src/repro/kernels/flash_attention/kernel.py``
(``flash_attention_kernel``): forward causal or sliding-window GQA attention
with an online softmax, float32 accumulation and key tiles that no row can
see skipped.  Bound by operations (4 B Hq D per visible query-key pair); the
source's header says what each route does about it: bf16 runs on the tensor
cores (a TMA producer warp, two consumer warpgroups that ping-pong their
wgmma, one persistent block an SM), float32 on the CUDA cores.

:func:`flash_attention` launches the CUDA kernel on CUDA tensors and raises
on anything else; ``ops.flash_attention`` chooses between it and the plain
version.  ``LAUNCHES`` counts the kernel launches.  The TPU kernel's tile
rule (``s % bq``) is layout and is not kept: any sequence length is taken.
Its VMEM budget becomes :func:`smem_bytes` checked against
``build.SMEM_BUDGET_BYTES``.
"""

from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import build

LAUNCHES = 0
MAX_D = 256                 # the accumulator's capacity (16 columns a group)
DTYPES = (torch.float32, torch.bfloat16)
# as in csrc/flash_attention.cu: the float32 route's query rows a block, key
# rows a tile and P row stride (in floats); the bf16 route's query rows a
# block, K / V ring stages and bytes of its mbarriers, and its key rows a
# tile by instantiation width (tc_keys).  Neither declares a static shared
# array.
F32_BQ, F32_BK = 64, 64
F32_P_STRIDE = F32_BK + 16
TC_ROWS, TC_STAGES, TC_BARRIER_BYTES = 128, 2, 128
TC_KEYS = {64: 128, 128: 64, 256: 32}
STATIC_SMEM_BYTES = 0


def _lib() -> ctypes.CDLL:
    lib = build.library("flash_attention")
    fn = lib.flash_attention
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 9 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    lib.flash_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.flash_attention_smem_bytes.restype = ctypes.c_int
    return lib


def tc_width(d: int) -> int:
    """The bf16 instantiation (64, 128 or 256) that serves head dimension
    ``d``."""
    return 64 if d <= 64 else 128 if d <= 128 else 256


def smem_bytes(d: int, dtype: torch.dtype) -> int:
    """Shared memory of one block of the kernel that serves head dimension
    ``d`` in ``dtype``, in bytes (all of it dynamic).  bf16: Q, then
    ``TC_STAGES`` K and V tiles of ``TC_KEYS`` rows at the instantiation's
    width, the barriers, and 1 KB to align the tiles to the swizzle's
    period; float32: Q and K with two padding columns, V, and P at its
    padded stride.  Mirrors the source's ``flash_attention_smem_bytes``."""
    if dtype == torch.bfloat16:
        dp = tc_width(d)
        return (STATIC_SMEM_BYTES + (TC_ROWS + 2 * TC_STAGES * TC_KEYS[dp])
                * dp * 2 + TC_BARRIER_BYTES + 1024)
    floats = (F32_BQ * (d + 2) + F32_BK * (d + 2) + F32_BK * d
              + F32_BQ * F32_P_STRIDE)
    return STATIC_SMEM_BYTES + 4 * floats


def c_smem_bytes(d: int, dtype: torch.dtype) -> int:
    """The source's ``flash_attention_smem_bytes(d, bf16)`` (builds the
    library on first use)."""
    return _lib().flash_attention_smem_bytes(d, int(dtype == torch.bfloat16))


def check_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> int:
    """Validate (B, Hq, S, D) / (B, Hkv, Skv, D) shapes; return the group."""
    if q.dim() != 4 or k.dim() != 4 or v.shape != k.shape:
        raise ValueError(f"q must be (B, Hq, S, D) and k, v (B, Hkv, S, D), "
                         f"got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    b, hq, _, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"k {tuple(k.shape)} does not match q "
                         f"{tuple(q.shape)} in batch or head dimension")
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads must be a multiple of kv heads for GQA, "
                         f"got hq={hq}, hkv={hkv}")
    return hq // hkv


def check_head_dim(d: int) -> None:
    """The kernel takes a head dimension that is a multiple of 16 up to
    ``MAX_D`` (bf16 runs it on the 64, 128 or 256 instantiation at or above
    it); anything else raises."""
    if d % 16 or not 16 <= d <= MAX_D:
        raise ValueError(f"the kernel takes a head dimension that is a "
                         f"multiple of 16 up to {MAX_D}, got {d}")


def check_aligned(x: torch.Tensor, name: str) -> None:
    """The bf16 route reads through TMA tensor maps: the base pointer and
    the batch, head and sequence strides (of dimensions longer than 1) must
    be multiples of 16 bytes.  Raises otherwise; nothing is copied to make
    them so."""
    size = x.element_size()
    bad = [st for n, st in zip(x.shape[:3], x.stride()[:3]) if n > 1
           and st * size % 16]
    if x.data_ptr() % 16 or bad:
        raise ValueError(f"{name}: the bf16 kernel needs a 16-byte aligned "
                         f"base pointer and strides, got address "
                         f"{x.data_ptr()} (mod 16 = {x.data_ptr() % 16}) and "
                         f"strides {tuple(x.stride())} of {size}-byte "
                         f"elements")


def _rows(x: torch.Tensor) -> torch.Tensor:
    """x itself when its last dimension is contiguous, else a copy."""
    return x if x.stride(3) == 1 else x.contiguous()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """q: (B, Hq, S, D), k, v: (B, Hkv, Skv, D) CUDA tensors of one dtype
    (float32 or bf16), any strides with the last dimension contiguous (in
    bf16 also 16-byte aligned, :func:`check_aligned`).  Returns o
    (B, Hq, S, D) in q's dtype and q's memory layout."""
    global LAUNCHES
    group = check_gqa(q, k, v)
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.device.type != "cuda":
            raise ValueError(f"{name} is on {x.device}: the kernel takes "
                             f"CUDA tensors")
        if x.dtype != q.dtype or x.device != q.device:
            raise TypeError(f"{name} is {x.dtype} on {x.device}, q is "
                            f"{q.dtype} on {q.device}")
    if q.dtype not in DTYPES:
        raise TypeError(f"the kernel takes float32 or bf16, got {q.dtype}")
    b, hq, s, d = q.shape
    check_head_dim(d)
    if smem_bytes(d, q.dtype) > build.SMEM_BUDGET_BYTES:
        raise ValueError(f"a block needs {smem_bytes(d, q.dtype)} bytes of "
                         f"shared memory at D={d} in {q.dtype}, over the "
                         f"{build.SMEM_BUDGET_BYTES}-byte budget")
    if window is not None and window <= 0:
        raise ValueError(f"window must be positive, got {window}")
    q, k, v = _rows(q), _rows(k), _rows(v)
    o = torch.empty_like(q)     # q's layout: (B, S, H, D) views stay so
    if q.dtype == torch.bfloat16:
        for name, x in (("q", q), ("k", k), ("v", v), ("o", o)):
            check_aligned(x, name)
    strides = (ctypes.c_longlong * 12)(*(st for x in (q, k, v, o)
                                         for st in x.stride()[:3]))
    lib = _lib()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = lib.flash_attention(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            ctypes.addressof(strides), b, hq, s, k.shape[2], d, group,
            int(causal), 0 if window is None else int(window),
            int(q.dtype == torch.bfloat16), stream)
    build.check(lib, rc, "flash_attention")
    LAUNCHES += 1
    return o
