"""The GNN data pipeline of the PyTorch port against ``repro``, array for
array: ``CSR.from_edges`` (with and without weights), ``sample_subtree``
uniform and weighted and ``minibatch`` under generators seeded alike (the
weighted branch draws one ``rng.choice`` a row), on a graph with isolated
vertices (padding entries, mask False); and ``graphgen.mesh2d``,
``gnn_full_batch`` and ``gnn_molecule_batch``.  Host numpy on both sides:
every array must be equal, dtype included."""

import numpy as np
import pytest

from repro.data import graphgen as jgen
from repro.models.gnn import sampler as jsam
from repro_torch.data import graphgen as tgen
from repro_torch.models.gnn import sampler as tsam


def assert_arrays_equal(got, want):
    if isinstance(want, dict):
        assert set(got) == set(want)
        for k in want:
            assert_arrays_equal(got[k], want[k])
        return
    if isinstance(want, (tuple, list)):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            assert_arrays_equal(g, w)
        return
    if isinstance(want, np.ndarray):
        assert isinstance(got, np.ndarray) and got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
        return
    assert got == want


def _graph(seed=0, n=300, m=900):
    """An Erdos-Renyi graph on n vertices, the first 20 of them isolated,
    and a positive weight on every edge."""
    edges = jgen.erdos_renyi(n - 20, m, seed=seed) + 20
    w = np.random.default_rng(seed).random(len(edges)).astype(np.float32)
    return n, edges, w + 0.05


@pytest.mark.parametrize("weighted", [False, True])
def test_csr_from_edges_matches_the_reference(weighted):
    n, edges, w = _graph()
    w = w if weighted else None
    want = jsam.CSR.from_edges(n, edges, edge_w=w)
    got = tsam.CSR.from_edges(n, edges, edge_w=w)
    assert_arrays_equal((got.indptr, got.nbrs), (want.indptr, want.nbrs))
    if weighted:
        assert_arrays_equal(got.edge_w, want.edge_w)
    else:
        assert got.edge_w is None


@pytest.mark.parametrize("fanouts", [(5, 3), (4,), (3, 2, 2)])
@pytest.mark.parametrize("weighted", [False, True])
def test_sample_subtree_matches_the_reference(weighted, fanouts):
    n, edges, w = _graph(seed=1)
    w = w if weighted else None
    seeds = np.array([30, 5, n - 1, 17, n - 3, 99])     # two isolated
    want = jsam.sample_subtree(jsam.CSR.from_edges(n, edges, edge_w=w),
                               seeds, fanouts, np.random.default_rng(7))
    got = tsam.sample_subtree(tsam.CSR.from_edges(n, edges, edge_w=w),
                              seeds, fanouts, np.random.default_rng(7))
    assert_arrays_equal(got, want)
    nodes, ei, mask = got
    assert not mask.all() and (nodes[len(seeds):][~mask] == 0).all()
    assert ei.shape == (len(mask), 2)


@pytest.mark.parametrize("weighted", [False, True])
def test_minibatch_matches_the_reference(weighted):
    n, edges, w = _graph(seed=2)
    w = w if weighted else None
    rng = np.random.default_rng(3)
    feats = rng.standard_normal((n, 6)).astype(np.float32)
    labels = rng.integers(0, 4, n).astype(np.int32)
    rj, rt = np.random.default_rng(11), np.random.default_rng(11)
    csr_j = jsam.CSR.from_edges(n, edges, edge_w=w)
    csr_t = tsam.CSR.from_edges(n, edges, edge_w=w)
    for _ in range(3):      # the generators stay in step across batches
        want = jsam.minibatch(csr_j, feats, labels, 16, (5, 3), rj)
        got = tsam.minibatch(csr_t, feats, labels, 16, (5, 3), rt)
        assert_arrays_equal(got, want)
    assert got["node_feat"].shape == (16 * (1 + 5 + 15), 6)


@pytest.mark.parametrize("rows,cols", [(1, 5), (4, 6), (7, 3)])
def test_mesh2d_matches_the_reference(rows, cols):
    assert_arrays_equal(tgen.mesh2d(rows, cols), jgen.mesh2d(rows, cols))


@pytest.mark.parametrize("regression", [False, True])
@pytest.mark.parametrize("with_positions", [False, True])
def test_gnn_full_batch_matches_the_reference(regression, with_positions):
    n, edges, pos = jgen.mesh2d(5, 7)
    pos = pos if with_positions else None
    want = jgen.gnn_full_batch(n, edges, 9, 4, seed=3, positions=pos,
                               regression=regression)
    got = tgen.gnn_full_batch(n, edges, 9, 4, seed=3, positions=pos,
                              regression=regression)
    assert_arrays_equal(got, want)


@pytest.mark.parametrize("n_graphs,nodes,edges", [(3, 10, 16), (8, 30, 64)])
def test_gnn_molecule_batch_matches_the_reference(n_graphs, nodes, edges):
    want = jgen.gnn_molecule_batch(n_graphs, nodes, edges, 16, seed=5)
    got = tgen.gnn_molecule_batch(n_graphs, nodes, edges, 16, seed=5)
    assert_arrays_equal(got, want)
    assert got["node_feat"].shape == (n_graphs * nodes, 16)


def test_an_isolated_last_vertex_raises_as_in_the_reference():
    """The uniform branch reads ``nbrs[indptr[v] + idx]`` before masking:
    for an isolated last vertex that is one past the end, and the reference
    raises ``IndexError`` (ROADMAP.md, section C); the port does the
    same."""
    edges = np.array([[0, 1], [1, 2]])
    for sam in (jsam, tsam):
        with pytest.raises(IndexError):
            sam.sample_subtree(sam.CSR.from_edges(4, edges), np.array([3]),
                               (2,), np.random.default_rng(0))
