"""Embedding bag of the PyTorch port against ``repro``.

On CPU tensors the port's op takes its plain version; it is held against
the JAX Pallas kernel in interpret mode (which pads D to 128 lanes, the
port does not) on the shapes of ``tests/test_kernels.py::TestEmbeddingBag``
and the bf16 case.  Tolerances: 1e-5 in float32 (the sums run in other
orders), 0.05 in bf16 (one bf16 rounding of sums of size ~3).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ref as jref
from repro.kernels.embedding_bag.ops import embedding_bag as jbag
from repro_torch.kernels.embedding_bag import kernel as tbk
from repro_torch.kernels.embedding_bag import ops as tops
from repro_torch.kernels.embedding_bag import ref as tref


@pytest.mark.parametrize("V,D,B,L,mode", [
    (64, 18, 8, 10, "mean"), (128, 128, 16, 4, "sum"),
    (32, 100, 4, 7, "mean"), (256, 64, 2, 100, "sum"),
])
def test_bag_matches_pallas_interpret(rng, V, D, B, L, mode):
    tbl = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    want = np.asarray(jbag(jnp.asarray(tbl), jnp.asarray(idx), mode=mode,
                           interpret=True))
    launches = tbk.LAUNCHES
    got = tops.embedding_bag(torch.from_numpy(tbl), torch.from_numpy(idx),
                             mode=mode)
    assert tbk.LAUNCHES == launches          # CPU tensor: no kernel launch
    assert got.dtype == torch.float32 and got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bag_bf16(rng):
    tbl = rng.standard_normal((64, 32)).astype(np.float32)
    idx = rng.integers(0, 64, (4, 8)).astype(np.int32)
    want = np.asarray(jbag(jnp.asarray(tbl).astype(jnp.bfloat16),
                           jnp.asarray(idx), mode="sum", interpret=True),
                      np.float32)
    got = tops.embedding_bag(torch.from_numpy(tbl).to(torch.bfloat16),
                             torch.from_numpy(idx), mode="sum")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want, rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("mode", ["sum", "mean"])
def test_weighted_ref_matches_jax_ref(rng, mode):
    tbl = rng.standard_normal((50, 18)).astype(np.float32)
    idx = rng.integers(0, 50, (6, 9)).astype(np.int32)
    w = rng.random((6, 9)).astype(np.float32)
    want = np.asarray(jref.embedding_bag(jnp.asarray(tbl), jnp.asarray(idx),
                                         mode=mode, weights=jnp.asarray(w)))
    got = tref.embedding_bag(torch.from_numpy(tbl), torch.from_numpy(idx),
                             mode=mode, weights=torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bag_argument_checks():
    tbl = torch.zeros((8, 4))
    idx = torch.zeros((2, 3), dtype=torch.int32)
    with pytest.raises(ValueError, match="mode"):
        tops.embedding_bag(tbl, idx, mode="max")
    with pytest.raises(TypeError, match="int32"):
        tops.embedding_bag(tbl, idx.float())
    with pytest.raises(ValueError, match=r"\(V, D\)"):
        tops.embedding_bag(tbl[0], idx)
    # the kernel binding takes CUDA tensors only; it never falls back
    with pytest.raises(ValueError, match="CUDA"):
        tbk.embedding_bag(tbl, idx)
