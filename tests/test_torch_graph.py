"""Graph layer and generators of the PyTorch port against ``repro``.

Host numpy on both sides, so every comparison is exact: each packed array
of ``build_graph`` and of ``Graph.remove_edges``, the edge-id helpers, and
the seeded generators.
"""

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.data import graphgen as jgen
from repro_torch import interop
from repro_torch.core import graph as tgraph
from repro_torch.data import graphgen as tgen
from tests.conftest import conformance_corpus

torch.manual_seed(0)

ARRAYS = ("edges", "deg", "rank", "src", "dst", "indptr", "nbrs", "nbr_eid")


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = jgen.rmat(10, 6, seed=4)
    out.append(("rmat10", n, e))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]


def _assert_same_graph(a, b, tag=""):
    assert a.n == b.n and a.m == b.m and a.max_out_deg == b.max_out_deg, tag
    for name in ARRAYS:
        x, y = getattr(a, name), getattr(b, name)
        assert x.dtype == y.dtype, (tag, name)
        np.testing.assert_array_equal(x, y, err_msg=f"{tag} {name}")


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_build_graph_arrays_equal(name, n, edges):
    _assert_same_graph(tgraph.build_graph(n, edges),
                       jgraph.build_graph(n, edges), name)


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_remove_edges_equal(name, n, edges):
    rng = np.random.default_rng(len(edges))
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    for frac in (0.0, 0.3, 1.0):
        mask = rng.random(tg.m) < frac
        tg2, jg2 = tg.remove_edges(mask), jg.remove_edges(mask)
        _assert_same_graph(tg2, jg2, f"{name} frac={frac}")
        # chained removal keeps the reused rank
        mask2 = rng.random(tg2.m) < 0.5
        _assert_same_graph(tg2.remove_edges(mask2), jg2.remove_edges(mask2),
                           f"{name} chained")
    with pytest.raises(ValueError):
        tg.remove_edges(np.zeros(tg.m + 1, bool))


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_edge_helpers_equal(name, n, edges):
    rng = np.random.default_rng(7)
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    a, b = rng.integers(0, n, 200), rng.integers(0, n, 200)
    np.testing.assert_array_equal(tgraph.edge_id_lookup(tg, a, b),
                                  jgraph.edge_id_lookup(jg, a, b))
    np.testing.assert_array_equal(tgraph.closed_wedge_estimate(tg),
                                  jgraph.closed_wedge_estimate(jg))
    sub = edges[rng.random(len(edges)) < 0.5]
    for x, y in zip(tgraph.compact_edge_list(sub),
                    jgraph.compact_edge_list(sub)):
        np.testing.assert_array_equal(x, y)
    np.testing.assert_array_equal(tgraph.incident_vertices(sub),
                                  jgraph.incident_vertices(sub))
    ids = np.unique(rng.integers(0, len(edges), 20))
    np.testing.assert_array_equal(tgraph.compact_index(ids, ids[::2]),
                                  jgraph.compact_index(ids, ids[::2]))
    np.testing.assert_array_equal(tgraph.degrees(n, edges),
                                  jgraph.degrees(n, edges))


def test_canonical_edges_equal_and_validated():
    rng = np.random.default_rng(3)
    raw = rng.integers(0, 30, (400, 2))     # duplicates, loops, reversed
    np.testing.assert_array_equal(tgraph.canonical_edges(raw, 30),
                                  jgraph.canonical_edges(raw, 30))
    np.testing.assert_array_equal(tgraph.canonical_edges(raw),
                                  jgraph.canonical_edges(raw))
    assert tgraph.canonical_edges(np.zeros((0, 2))).shape == (0, 2)
    with pytest.raises(ValueError):
        tgraph.canonical_edges([[0, -1]])
    with pytest.raises(ValueError):
        tgraph.canonical_edges([[0, 30]], 30)


def test_empty_graph_equal():
    _assert_same_graph(tgraph.build_graph(5, np.zeros((0, 2))),
                       jgraph.build_graph(5, np.zeros((0, 2))), "empty")
    tg = tgraph.build_graph(5, np.zeros((0, 2)))
    assert (tgraph.edge_id_lookup(tg, np.array([0]), np.array([1])) == -1).all()


@pytest.mark.parametrize("args", [(8, 6, 5), (10, 4, 1), (9, 16, 0)])
def test_rmat_equal(args):
    (tn, te), (jn, je) = tgen.rmat(*args), jgen.rmat(*args)
    assert tn == jn
    np.testing.assert_array_equal(te, je)


def test_other_generators_equal():
    np.testing.assert_array_equal(tgen.erdos_renyi(300, 2000, seed=5),
                                  jgen.erdos_renyi(300, 2000, seed=5))
    np.testing.assert_array_equal(tgen.planted_cliques(100, 3, 8, 50, seed=2),
                                  jgen.planted_cliques(100, 3, 8, 50, seed=2))


@pytest.mark.parametrize("name,n,edges", GRAPHS[:2], ids=IDS[:2])
def test_interop_graph_carries_every_array(name, n, edges):
    jg = jgraph.build_graph(n, edges)
    _assert_same_graph(interop.graph(jg), jg, name)
