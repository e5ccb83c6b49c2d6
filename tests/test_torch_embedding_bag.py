"""Embedding bag of the PyTorch port against ``repro``.

On CPU tensors the port's op takes its plain version; it is held against
the JAX Pallas kernel in interpret mode (which pads D to 128 lanes, the
port does not) on the shapes of ``tests/test_kernels.py::TestEmbeddingBag``,
the bf16 case and the shapes that reach each branch of the CUDA kernel's
row layout (D = 17, 128, 256; L = 1; B = 1).  Tolerances: 1e-5 in float32
(the sums run in other orders), 0.05 in bf16 (one bf16 rounding of sums of
size ~3).

The CUDA kernel has two entries, chosen by the bag length
(``kernel.entry``).  The warp entry sums each bag in another order than the
reference (row groups by lane, combined at the end); ``kernel_order`` models
that order in numpy.  The small-bag entry sums each bag in bag order from
0.0 and scales a mean by 1 / L (``small_order``), so a sum of one row is
the row.  Each model is held,
at the shapes its entry serves, to the limits the card holds the kernel to
(``chip_smoke.B4_TOL``, ``B4_BF16_TOL``), so the tolerance is known to hold
before the card is used; at L = 1 the small order equals DIN's take
exactly.  Change a model with its entry.
"""

import importlib.util
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.embedding_bag import ref as jref
from repro.kernels.embedding_bag.ops import embedding_bag as jbag
from repro.configs import registry as jregistry
from repro.configs.reduced import reduced_din as jreduced_din
from repro.models.recsys import din as JD
from repro_torch import interop
from repro_torch.configs import registry as tregistry
from repro_torch.configs.reduced import reduced_din
from repro_torch.kernels.embedding_bag import kernel as tbk
from repro_torch.kernels.embedding_bag import ops as tops
from repro_torch.kernels.embedding_bag import ref as tref
from repro_torch.models.recsys import din as TD


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


def small_order(table: np.ndarray, idx: np.ndarray,
                mode: str) -> np.ndarray:
    """The small-bag entry's float32 sums: one lane per vector adds the
    bag's rows in bag order to 0.0; a mean multiplies once by 1 / L."""
    B, L = idx.shape
    acc = np.zeros((B, table.shape[1]), np.float32)
    for l in range(L):
        acc += table[idx[:, l]]
    return acc * (np.float32(1) / np.float32(L)) if mode == "mean" else acc


def entry_order(table, idx, mode, itemsize):
    """The float32 sums of the entry that ``tbk.entry`` picks for idx's L."""
    if tbk.entry(idx.shape[1]) == "small":
        return small_order(table, idx, mode)
    return kernel_order(table, idx, mode,
                        tbk.layout(table.shape[1], itemsize).rows)


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
    (18, 4, 4, (4, 18, 1, 1)),       # a table one float off
    (256, 2, 2, (2, 256, 1, 8)),     # bf16 one element off: eight passes
    (256, 2, 0, (16, 32, 1, 1)),
])
def test_layout(D, itemsize, address, want):
    """The row layout both entries read with."""
    assert tuple(tbk.layout(D, itemsize, address)) == want


@pytest.mark.parametrize("L,want", [
    (0, "small"), (1, "small"), (2, "small"), (3, "small"), (7, "small"),
    (8, "small"), (9, "warp"), (16, "warp"), (100, "warp"), (300, "warp"),
])
def test_entry_rule(L, want):
    """Bags of up to L_SMALL rows take the small-bag entry, whatever the
    row's layout; DIN's lookups (L = 1) among them."""
    assert tbk.L_SMALL == 8 and tbk.entry(L) == want


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("mode", ["sum", "mean"])
@pytest.mark.parametrize("D,L", [(18, 100), (17, 100), (256, 300), (18, 1),
                                 (18, 2), (17, 3), (128, 7), (256, 16)])
def test_kernel_order_within_card_tolerance(rng, dtype, mode, D, L):
    """The order of the entry ``tbk.entry(L)`` takes."""
    V, B = 5000, 64
    tbl = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    jt = jnp.asarray(tbl)
    if dtype == "bf16":
        jt = jt.astype(jnp.bfloat16)
        tbl = np.asarray(jt.astype(jnp.float32))    # the bf16 values
    want = np.asarray(jref.embedding_bag(jt, jnp.asarray(idx), mode=mode)
                      .astype(jnp.float32))
    got = entry_order(tbl, idx, mode, 4 if dtype == "float32" else 2)
    if L == 1:      # one row from 0.0: the row itself, in either mode
        np.testing.assert_array_equal(got, tbl[idx[:, 0]])
    tol = SMOKE.B4_TOL
    if dtype == "bf16":
        got = torch.from_numpy(got).to(torch.bfloat16).float().numpy()
        tol = SMOKE.B4_BF16_TOL
    np.testing.assert_allclose(got, want, **tol)


@pytest.mark.parametrize("V,D,B,L,mode", [
    (40, 17, 4, 7, "sum"), (40, 128, 3, 5, "mean"), (40, 256, 2, 6, "sum"),
    (40, 18, 5, 1, "mean"), (40, 18, 1, 9, "sum"), (40, 256, 1, 1, "mean"),
    (40, 18, 25, 1, "sum"), (40, 18, 1, 2, "mean"), (40, 17, 7, 3, "sum"),
    (40, 128, 1, 7, "mean"), (40, 256, 3, 2, "sum"), (40, 18, 26, 3, "mean"),
])
def test_bag_layout_shapes_match_pallas_interpret(rng, V, D, B, L, mode):
    """The plain version against the Pallas kernel in interpret mode and
    the reference's own plain version (exactly for a sum of one row)."""
    tbl = rng.standard_normal((V, D)).astype(np.float32)
    idx = rng.integers(0, V, (B, L)).astype(np.int32)
    want = np.asarray(jbag(jnp.asarray(tbl), jnp.asarray(idx), mode=mode,
                           interpret=True))
    want_ref = np.asarray(jref.embedding_bag(jnp.asarray(tbl),
                                             jnp.asarray(idx), mode=mode))
    got = tops.embedding_bag(torch.from_numpy(tbl), torch.from_numpy(idx),
                             mode=mode)
    assert got.shape == (B, D)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got.numpy(), want_ref, rtol=1e-5, atol=1e-5)
    if (L, mode) == (1, "sum"):
        np.testing.assert_array_equal(got.numpy(), want_ref)


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


@pytest.mark.parametrize("B,L,mode", [(1, 1, "sum"), (1, 2, "mean"),
                                      (5, 3, "sum"), (1, 7, "mean")])
def test_bag_bf16_d17_small_bags_match_pallas_interpret(rng, B, L, mode):
    """bf16 at D = 17 (one bf16 a load) in small bags, B = 1 included,
    against the Pallas kernel in interpret mode and the reference's plain
    version."""
    tbl = rng.standard_normal((40, 17)).astype(np.float32)
    idx = rng.integers(0, 40, (B, L)).astype(np.int32)
    jt = jnp.asarray(tbl).astype(jnp.bfloat16)
    want = np.asarray(jbag(jt, jnp.asarray(idx), mode=mode, interpret=True),
                      np.float32)
    want_ref = np.asarray(jref.embedding_bag(jt, jnp.asarray(idx), mode=mode)
                          .astype(jnp.float32))
    got = tops.embedding_bag(torch.from_numpy(tbl).to(torch.bfloat16),
                             torch.from_numpy(idx), mode=mode)
    assert got.dtype == torch.bfloat16 and got.shape == (B, 17)
    np.testing.assert_allclose(got.float().numpy(), want,
                               **SMOKE.B4_BF16_TOL)
    np.testing.assert_allclose(got.float().numpy(), want_ref,
                               **SMOKE.B4_BF16_TOL)


@pytest.mark.parametrize("lookup", ["hist", "cand"])
def test_din_bag_route_equals_the_take(lookup):
    """DIN's lookups are bags of one row: the bag route (on the CPU the
    plain version) and the small-bag entry's order (``small_order``) both
    equal the take and the reference's ``_lookup`` exactly, a -0.0 entry
    of the table included (``0.0 + -0.0`` is 0.0, which compares equal)."""
    jcfg = jreduced_din(jregistry.get_config("din"))
    tcfg = reduced_din(tregistry.get_config("din"))
    rng = np.random.default_rng(0)
    item = rng.standard_normal((tcfg.n_items, tcfg.embed_dim)) \
        .astype(np.float32)
    cat = rng.standard_normal((tcfg.n_cats, tcfg.embed_dim)) \
        .astype(np.float32)
    item[:, 0] = -0.0
    shape = (8, tcfg.seq_len) if lookup == "hist" else (8,)
    ids = rng.integers(0, tcfg.n_items, shape).astype(np.int32)
    cids = rng.integers(0, tcfg.n_cats, shape).astype(np.int32)
    assert tbk.entry(1) == "small"
    tp = interop.param_tree({"item_emb": item, "cat_emb": cat},
                            device="cpu")
    jp = {"item_emb": jnp.asarray(item), "cat_emb": jnp.asarray(cat)}
    want = np.asarray(JD._lookup(jp, jcfg, jnp.asarray(ids),
                                 jnp.asarray(cids)))
    bag = TD._lookup(tp, tcfg, torch.from_numpy(ids), torch.from_numpy(cids),
                     kernel="bag")
    take = TD._lookup(tp, tcfg, torch.from_numpy(ids),
                      torch.from_numpy(cids), kernel="take")
    flat = ids.reshape(-1, 1)
    model = (small_order(item, flat, "sum")
             + small_order(cat, cids.reshape(-1, 1), "sum"))
    np.testing.assert_array_equal(bag.numpy(), want)
    assert torch.equal(bag, take)
    np.testing.assert_array_equal(model.reshape(want.shape), want)
    np.testing.assert_array_equal(small_order(item, flat, "sum"),
                                  item[flat[:, 0]])


def test_entry_argument_checks():
    tbl = torch.zeros((8, 4))
    idx = torch.zeros((2, 1), dtype=torch.int32)
    with pytest.raises(ValueError, match="use must be one of"):
        tbk.embedding_bag(tbl, idx, mode="sum", use="thread")
    # either entry takes CUDA tensors only; neither falls back
    for use in tbk.ENTRIES:
        with pytest.raises(ValueError, match="CUDA"):
            tbk.embedding_bag(tbl, idx, mode="sum", use=use)


def test_probe_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        tbk.gather_probe(torch.zeros((8, 4)),
                         torch.zeros((2, 3), dtype=torch.int32))
