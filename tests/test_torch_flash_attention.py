"""Flash attention of the PyTorch port against ``repro``.

On CPU tensors the port's op takes its plain version; it is held here
against the JAX Pallas kernel in interpret mode, on the shapes of
``tests/test_kernels.py::TestFlashAttention`` plus gemma3-4b's head shape
(D = 256, Hq 8 / Hkv 4) with a window.  Tolerances: rtol = atol = 2e-5 in
float32 (the two sum in different orders), 0.05 in bf16 (one bf16 rounding
of outputs of size ~1).  The long-sequence plain paths (``chunked_attention``,
``banded_attention``) are held against the JAX package's at the same
float32 tolerance.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.ops import flash_attention as jflash
from repro.models import attention as jatt
from repro_torch.kernels.flash_attention import kernel as tfk
from repro_torch.kernels.flash_attention import ops as tops
from repro_torch.kernels.flash_attention import ref as tref
from repro_torch.models import attention as tatt

F32_TOL = dict(rtol=2e-5, atol=2e-5)
BF16_TOL = dict(rtol=0.05, atol=0.05)


def _qkv(rng, B, Hq, Hkv, S, D):
    return (rng.standard_normal((B, Hq, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32),
            rng.standard_normal((B, Hkv, S, D)).astype(np.float32))


@pytest.mark.parametrize("B,Hq,Hkv,S,D,win,causal", [
    (2, 4, 2, 256, 64, None, True),
    (1, 8, 8, 128, 128, None, True),
    (2, 4, 1, 256, 64, 96, True),
    (1, 2, 2, 512, 32, 128, True),
    (1, 8, 4, 128, 256, 48, True),        # gemma3-4b heads, local layer
    (1, 4, 2, 128, 16, 40, False),        # window without causal
])
def test_flash_matches_pallas_interpret(rng, B, Hq, Hkv, S, D, win, causal):
    q, k, v = _qkv(rng, B, Hq, Hkv, S, D)
    want = np.asarray(jflash(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                             causal=causal, window=win, bq=64, bk=64,
                             interpret=True))
    launches = tfk.LAUNCHES
    got = tops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                               torch.from_numpy(v), causal=causal, window=win)
    assert tfk.LAUNCHES == launches          # CPU tensor: no kernel launch
    assert got.dtype == torch.float32 and got.shape == q.shape
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)


def test_flash_bf16(rng):
    q, k, v = _qkv(rng, 1, 8, 4, 128, 256)
    jq, jk, jv = (jnp.asarray(x).astype(jnp.bfloat16) for x in (q, k, v))
    want = np.asarray(jflash(jq, jk, jv, window=64, bq=64, bk=64,
                             interpret=True), np.float32)
    tq, tk, tv = (torch.from_numpy(x).to(torch.bfloat16) for x in (q, k, v))
    got = tops.flash_attention(tq, tk, tv, window=64)
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, **BF16_TOL)


def test_flash_gqa_check_and_device_rules():
    q = torch.zeros((1, 3, 8, 16))
    k = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tops.flash_attention(q, k, k)
    with pytest.raises(ValueError, match="multiple of kv heads"):
        tfk.check_gqa(q, k, k)
    # the kernel binding takes CUDA tensors only; it never falls back
    q = torch.zeros((1, 2, 8, 16))
    with pytest.raises(ValueError, match="CUDA"):
        tfk.flash_attention(q, k, k)


@pytest.mark.parametrize("B,S,Hq,Hkv,D,qc,kc,win", [
    (2, 128, 4, 2, 32, 32, 64, 48),
    (1, 256, 8, 4, 256, 64, 64, 96),      # gemma3-4b heads
])
def test_chunked_and_banded_match_jax(rng, B, S, Hq, Hkv, D, qc, kc, win):
    q = rng.standard_normal((B, S, Hq, D)).astype(np.float32)
    k = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    v = rng.standard_normal((B, S, Hkv, D)).astype(np.float32)
    jq, jk, jv = jnp.asarray(q), jnp.asarray(k), jnp.asarray(v)
    tq, tk, tv = torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v)
    want = np.asarray(jatt.chunked_attention(jq, jk, jv, q_chunk=qc,
                                             k_chunk=kc))
    got = tatt.chunked_attention(tq, tk, tv, q_chunk=qc, k_chunk=kc)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    want = np.asarray(jatt.banded_attention(jq, jk, jv, window=win,
                                            q_chunk=qc))
    got = tatt.banded_attention(tq, tk, tv, window=win, q_chunk=qc)
    np.testing.assert_allclose(got.numpy(), want, **F32_TOL)
    # and both against the plain version of the kernel
    t = lambda x: x.transpose(1, 2)
    np.testing.assert_allclose(
        got.numpy(), t(tref.mha_reference(t(tq), t(tk), t(tv), window=win))
        .numpy(), **F32_TOL)
    with pytest.raises(ValueError, match="divide"):
        tatt.banded_attention(tq, tk, tv, window=win, q_chunk=S - 1)
