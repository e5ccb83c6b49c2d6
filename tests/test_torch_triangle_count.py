"""Dense triangle counting of the PyTorch port against ``repro``.

The port's wrapper takes its plain version on CPU tensors; it is held here
against the JAX Pallas kernel in interpret mode (f32 counts, exact for 0/1
inputs at these sizes) and ``dense_edge_support`` against the JAX wrapper
and the numpy support oracle.  The ``symmetric=True`` route (the kernel then
reads A's rows as A^T's) and a non-symmetric A are held against the Pallas
kernel too.  All comparisons are exact.
"""

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core.support import edge_support_np
from repro.kernels.triangle_count import kernel as jtk
from repro.kernels.triangle_count import ops as jops
from repro_torch.kernels.triangle_count import kernel as ttk
from repro_torch.kernels.triangle_count import ops as tops
from tests.conftest import random_graph

torch.manual_seed(0)


def _edges(n, p, seed):
    rng = np.random.default_rng(seed)
    return jgraph.canonical_edges(random_graph(rng, n, p), n)


@pytest.mark.parametrize("n,p", [(128, 0.2), (256, 0.1)])
def test_support_dense_matches_pallas_interpret(n, p):
    edges = _edges(n, p, n)
    A_np = jops.adjacency_from_edges(n, edges)
    want = np.asarray(jtk.triangle_count_kernel(A_np, bm=128, bn=128, bk=128,
                                                interpret=True))
    A = tops.adjacency_from_edges(n, edges, device="cpu")
    assert A.dtype == torch.uint8
    np.testing.assert_array_equal(A.numpy(), A_np.astype(np.uint8))
    launches = ttk.LAUNCHES
    got = tops.dense_support(A)
    assert ttk.LAUNCHES == launches          # CPU tensor: no kernel launch
    assert got.dtype == torch.int32 and got.shape == (n, n)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))


@pytest.mark.parametrize("n,p", [(90, 0.25), (128, 0.3), (200, 0.3)])
def test_dense_edge_support_matches_reference(n, p):
    edges = _edges(n, p, 7 * n)
    got = tops.dense_edge_support(n, edges, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(
        got, jops.dense_edge_support(n, edges, interpret=True,
                                     use_kernel=False))
    np.testing.assert_array_equal(
        got, edge_support_np(jgraph.build_graph(n, edges)))


def test_wrapper_validates_inputs():
    with pytest.raises(ValueError):
        ttk.triangle_count(torch.zeros((4, 5), dtype=torch.uint8))
    with pytest.raises(TypeError):
        ttk.triangle_count(torch.zeros((4, 4), dtype=torch.float32))
    with pytest.raises(ValueError):
        tops.dense_support(torch.zeros((4, 4), dtype=torch.uint8),
                           kernel="pallas")
    assert tops.dense_edge_support(3, np.zeros((0, 2), np.int64),
                                   device="cpu").shape == (0,)


@pytest.mark.parametrize("n,p", [(128, 0.25), (200, 0.2)])
def test_symmetric_route_matches_pallas_interpret(n, p):
    edges = _edges(n, p, 3 * n)
    A_np = jops.adjacency_from_edges(n, edges)
    n_pad = -(-n // 128) * 128
    A_pad = np.zeros((n_pad, n_pad), A_np.dtype)
    A_pad[:n, :n] = A_np
    want = np.asarray(jtk.triangle_count_kernel(
        A_pad, bm=128, bn=128, bk=128, interpret=True))[:n, :n]
    A = tops.adjacency_from_edges(n, edges, device="cpu")
    got = tops.dense_support(A, symmetric=True)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(ttk.triangle_count(A, symmetric=True),
                                  ttk.triangle_count(A))


@pytest.mark.parametrize("n,p", [(128, 0.3), (256, 0.15)])
def test_non_symmetric_matches_pallas_interpret(n, p):
    """A directed 0/1 matrix with a diagonal: S = (A A) o A, not A A^T o A."""
    A_np = (np.random.default_rng(n).random((n, n)) < p).astype(np.float32)
    want = np.asarray(jtk.triangle_count_kernel(A_np, bm=128, bn=128, bk=128,
                                                interpret=True))
    A = torch.as_tensor(A_np.astype(np.uint8))
    got = ttk.triangle_count(A)
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    assert not np.array_equal(want, (A_np @ A_np.T) * A_np)


def test_dense_edge_support_promises_symmetry(monkeypatch):
    seen = []

    def spy(A, **kw):
        seen.append(kw)
        return ttk.ref.support_dense(A)

    monkeypatch.setattr(ttk, "triangle_count", spy)
    tops.dense_edge_support(40, _edges(40, 0.3, 1), device="cpu")
    assert seen == [dict(symmetric=True)]


@pytest.mark.parametrize("n,p", [(64, 0.3), (128, 0.2), (200, 0.15)])
def test_triangle_total_and_edge_support_match_jnp_ref(n, p):
    """``ref.triangle_total`` and ``ref.edge_support`` on the port's S of a
    seeded adjacency against the JAX package's jnp ``ref`` on its S, and
    against the numpy triangle list and support oracle: exact."""
    import jax.numpy as jnp

    from repro.core.support import list_triangles_np
    from repro.kernels.triangle_count import ref as jref
    from repro_torch.kernels.triangle_count import ref as tref

    edges = _edges(n, p, 11 * n)
    S_j = jref.support_dense(jnp.asarray(jops.adjacency_from_edges(n, edges)))
    S_t = tops.dense_support(tops.adjacency_from_edges(n, edges,
                                                       device="cpu"))
    total = tref.triangle_total(S_t)
    assert total.dtype == torch.float64 and total.shape == ()
    assert float(total) == float(jref.triangle_total(S_j))
    assert float(total) == len(list_triangles_np(jgraph.build_graph(n, edges)))
    e_t = torch.as_tensor(edges)
    got = tref.edge_support(S_t, e_t)
    assert got.dtype == torch.int32 and got.shape == (len(edges),)
    want = np.asarray(jref.edge_support(S_j, jnp.asarray(edges)))
    np.testing.assert_array_equal(got.numpy(), want.astype(np.int32))
    np.testing.assert_array_equal(
        got.numpy(), edge_support_np(jgraph.build_graph(n, edges)))
    # int32 edge ids gather the same rows
    np.testing.assert_array_equal(
        tref.edge_support(S_t, e_t.to(torch.int32)).numpy(), got.numpy())
