"""Decode attention (B5) on the card: the CUDA kernel against its plain
version, and its launch count.  Imports no JAX (the card's machine has
none).  Every test here needs an NVIDIA card and skips without one (the
fixture decides); on the card:

    python -m pytest -q tests/test_torch_decode_attention_card.py

The CPU tests of the binding, the plain version and the split are in
``tests/test_torch_decode_attention.py``.
"""

import pytest
import torch

from repro_torch.kernels.decode_attention import kernel as dk
from repro_torch.kernels.decode_attention import ref as dref

pytestmark = pytest.mark.card

# float32: the same float32 sums in other orders; bf16: one bf16 step where
# the two float32 values straddle a rounding point (chip_smoke.py's B5_TOL)
TOL = {torch.float32: dict(rtol=2e-5, atol=2e-5),
       torch.bfloat16: dict(rtol=2 ** -7, atol=2e-3)}
# (B, S, Hkv, group, D, window): DeepSeekMoE-16B's decode_b160 layer,
# gemma3-4b's local and global layers in the smoke, phi3.5-moe's (group 4),
# qwen2.5-14b's group 5 and a reduced config's D = 16
SHAPES = {"dsmoe16b-b160": (160, 640, 16, 1, 128, None),
          "gemma3-4b-local": (8, 2080, 4, 2, 256, 1024),
          "gemma3-4b-global": (8, 2080, 4, 2, 256, None),
          "phi3.5-moe": (8, 2080, 8, 4, 128, None),
          "group-5": (4, 300, 8, 5, 128, None),
          "reduced-d16": (8, 40, 2, 2, 16, 8)}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: B5 is a CUDA kernel, with no CPU "
                    "route")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _case(dev, shape, dtype, seed=0):
    B, S, Hkv, g, D, window = shape
    gen = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((B, 1, Hkv * g, D), generator=gen, device=dev).to(dtype)
    ck = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    cv = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    pos = torch.randint(0, S, (B,), generator=gen, device=dev,
                        dtype=torch.int32)
    pos[0], pos[-1] = 0, S - 1
    t = torch.arange(S, device=dev)[None, :]
    hidden = t > pos.long()[:, None]
    if window is not None:
        hidden |= t <= pos.long()[:, None] - window
    return q, ck, cv, pos, window, hidden[:, :, None, None]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["float32", "bf16"])
@pytest.mark.parametrize("name", list(SHAPES))
def test_kernel_matches_the_plain_version(dev, name, dtype):
    """Positions a row cannot see hold NaN for the kernel and 0 for the
    plain version: a hidden position read would show."""
    q, ck, cv, pos, window, hidden = _case(dev, SHAPES[name], dtype)
    nan = float("nan")
    got = dk.decode_attention(q, ck.masked_fill(hidden, nan),
                              cv.masked_fill(hidden, nan), pos, window)
    want = dref.decode_attention(q, ck.masked_fill(hidden, 0),
                                 cv.masked_fill(hidden, 0), pos, window)
    assert got.dtype == q.dtype and got.shape == q.shape
    assert bool(torch.isfinite(got).all())
    torch.testing.assert_close(got.float(), want.float(), **TOL[dtype])


def test_launches_count_each_kernel_launch(dev):
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for name in ("dsmoe16b-b160", "gemma3-4b-local"):
        q, ck, cv, pos, window, _ = _case(dev, SHAPES[name], torch.bfloat16)
        B, S, Hkv = ck.shape[:3]
        split = dk.split_plan(B * Hkv, S if window is None else min(
            S, window), sms)
        n = dk.LAUNCHES
        dk.decode_attention(q, ck, cv, pos, window)
        assert dk.LAUNCHES - n == (1 if split == 1 else 2), (name, split)
    assert dk.split_plan(160 * 16, 640, sms) == 1
    assert dk.split_plan(8 * 4, 2080, sms) > 1
