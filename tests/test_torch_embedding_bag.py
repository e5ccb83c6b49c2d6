"""Embedding bag of the PyTorch port against ``repro``.

On CPU tensors the port's op takes its plain version; it is held against
the JAX Pallas kernel in interpret mode (which pads D to 128 lanes, the
port does not) on the shapes of ``tests/test_kernels.py::TestEmbeddingBag``,
the bf16 case and the shapes that reach each branch of the CUDA kernel's
row layout (D = 17, 128, 256; L = 1; B = 1).  Tolerances: 1e-5 in float32
(the sums run in other orders), 0.05 in bf16 (one bf16 rounding of sums of
size ~3).

The CUDA kernel sums each bag in another order than the reference (row
groups by lane, combined at the end); ``kernel_order`` models that order in
numpy and is held, at DIN's L = 100 and D = 18, to the limits the card holds
the kernel to (``chip_smoke.B4_TOL``, ``B4_BF16_TOL``), so the tolerance is
known to hold before the card is used.  Change the model with the kernel.
"""

import importlib.util
from pathlib import Path

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


def _load_smoke():
    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SMOKE = _load_smoke()       # B4_TOL and B4_BF16_TOL: what the card checks


def kernel_order(table: np.ndarray, idx: np.ndarray, mode: str,
                 rows: int) -> np.ndarray:
    """The CUDA kernel's float32 sums: row group r adds, in bag order, the
    rows whose position in their group of ``tbk.STAGE`` staged indices is r
    modulo ``rows``; group 0 then adds groups 1, 2, ... in turn; a mean
    divides once by L."""
    B, L = idx.shape
    acc = np.zeros((rows, B, table.shape[1]), np.float32)
    for l in range(L):
        acc[(l % tbk.STAGE) % rows] += table[idx[:, l]]
    out = acc[0].copy()
    for k in range(1, rows):
        out += acc[k]
    return out / np.float32(L) if mode == "mean" else out


@pytest.mark.parametrize("D,itemsize,address,want", [
    (18, 4, 0, (8, 9, 3, 1)),        # DIN float32: float2, 3 rows a load
    (18, 2, 0, (4, 9, 3, 1)),        # DIN bf16: bf16x2
    (17, 4, 0, (4, 17, 1, 1)),       # 68-byte rows: the 4-byte fallback
    (17, 2, 0, (2, 17, 1, 1)),       # 34-byte rows: one bf16 a load
    (128, 4, 0, (16, 32, 1, 1)),     # float4, one row a load
    (128, 2, 0, (16, 16, 2, 1)),
    (256, 4, 0, (16, 64, 1, 2)),     # 1,024-byte rows: two passes
    (128, 4, 4, (4, 128, 1, 4)),     # a table 4 bytes off alignment
    (18, 4, 8, (8, 9, 3, 1)),
])
def test_layout(D, itemsize, address, want):
    assert tuple(tbk.layout(D, itemsize, address)) == want


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("D,L", [(18, 100), (17, 100), (256, 300)])
def test_kernel_order_within_card_tolerance(rng, dtype, mode, D, L):
    V, B = 5000, 64
    tbl = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    jt = jnp.asarray(tbl)
    if dtype == "bf16":
        jt = jt.astype(jnp.bfloat16)
        tbl = np.asarray(jt.astype(jnp.float32))    # the bf16 values
    want = np.asarray(jref.embedding_bag(jt, jnp.asarray(idx), mode=mode)
                      .astype(jnp.float32))
    rows = tbk.layout(D, 4 if dtype == "float32" else 2).rows
    got = kernel_order(tbl, idx, mode, rows)
    tol = SMOKE.B4_TOL
    if dtype == "bf16":
        got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        tol = SMOKE.B4_BF16_TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("V,D,B,L,mode", [
    (40, 17, 4, 7, "sum"), (40, 128, 3, 5, "mean"), (40, 256, 2, 6, "sum"),
    (40, 18, 5, 1, "mean"), (40, 18, 1, 9, "sum"), (40, 256, 1, 1, "mean"),
])
def test_bag_layout_shapes_match_pallas_interpret(rng, V, D, B, L, mode):
    tbl = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    want = np.asarray(jbag(jnp.asarray(tbl), jnp.asarray(idx), mode=mode,
                           interpret=True))
    got = tops.embedding_bag(torch.from_numpy(tbl), torch.from_numpy(idx),
                             mode=mode)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)


def test_bag_bf16_d17_matches_pallas_interpret(rng):
    tbl = rng.standard_normal((40, 17)).astype(np.float32)
    idx = rng.integers(0, 40, (3, 7)).astype(np.int32)
    want = np.asarray(jbag(jnp.asarray(tbl).astype(jnp.bfloat16),
                           jnp.asarray(idx), mode="mean", interpret=True),
                      np.float32)
    got = tops.embedding_bag(torch.from_numpy(tbl).to(torch.bfloat16),
                             torch.from_numpy(idx), mode="mean")
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(got.float().numpy(), want,
                               **SMOKE.B4_BF16_TOL)


def test_probe_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tbk.gather_probe(torch.zeros((8, 4)),
                         torch.zeros((2, 3), dtype=torch.int32))
