"""The port's k-core (``repro_torch.core.kcore``), sparsify utilities
(``core.sparsify``), global-iterate peel (``peel.peel_recompute``),
clustering coefficient and ``neighborhood_subgraph`` against ``repro``.

Core numbers, c_max-cores, filtered edge lists, phi, weights and features
are held to the reference's with exact equality (integers, or floats made
by the same operations on equal integers); the clustering coefficient is
the same float.  The port runs on the CPU.
"""

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import kcore as jkcore
from repro.core import peel as jpeel
from repro.core import sparsify as jsparsify
from repro.core.support import list_triangles_np as jlist
from repro_torch import device as tdevice
from repro_torch.core import graph as tgraph
from repro_torch.core import kcore as tkcore
from repro_torch.core import peel as tpeel
from repro_torch.core import sparsify as tsparsify
from tests.conftest import (clique_edges, conformance_corpus, er_graph,
                            rmat_graph)

CORPUS = conformance_corpus()
# the corpus, an R-MAT of scale 7, a clique, a star, a path and a graph with
# isolated vertices
GRAPHS = CORPUS + [
    ("rmat7", *rmat_graph(scale=7, edge_factor=8, seed=5)),
    ("k7", 9, tgraph.canonical_edges(clique_edges(1, 7), 9)),
    ("star", 12, np.stack([np.zeros(11, np.int64), np.arange(1, 12)], 1)),
    ("path", 10, np.stack([np.arange(9), np.arange(1, 10)], 1)),
    ("isolated", 30, er_graph(np.random.default_rng(3), 20, 0.3)[1]),
]
IDS = [g[0] for g in GRAPHS]


@pytest.mark.parametrize("name,n,ce", GRAPHS, ids=IDS)
def test_core_decompose_and_cmax_core_equal_reference(name, n, ce):
    core = tkcore.core_decompose(n, ce, device="cpu")
    np.testing.assert_array_equal(core, jkcore.core_decompose(n, ce))
    assert core.dtype == np.int64 and core.shape == (n,)
    cmax, edges = tkcore.cmax_core(n, ce, device="cpu")
    jcmax, jedges = jkcore.cmax_core(n, ce)
    assert cmax == jcmax
    np.testing.assert_array_equal(edges, jedges)


@pytest.mark.parametrize("case", ["empty", "no-edges", "multigraph"])
def test_core_decompose_degenerate_inputs(case):
    if case == "empty":
        n, e = 0, np.zeros((0, 2), np.int64)
    elif case == "no-edges":
        n, e = 5, np.zeros((0, 2), np.int64)
    else:          # duplicate edges, both orientations and a self loop
        n = 4
        e = np.array([[0, 1], [1, 0], [0, 1], [1, 2], [2, 0], [3, 3]])
    core = tkcore.core_decompose(n, e, device="cpu")
    np.testing.assert_array_equal(core, jkcore.core_decompose(n, e))
    assert tkcore.cmax_core(n, e, device="cpu")[0] == \
        jkcore.cmax_core(n, e)[0]


def test_core_of_clique_star_path():
    assert (tkcore.core_decompose(9, clique_edges(1, 7), device="cpu")[1:8]
            == 6).all()
    star = np.stack([np.zeros(11, np.int64), np.arange(1, 12)], 1)
    assert (tkcore.core_decompose(12, star, device="cpu") == 1).all()
    path = np.stack([np.arange(9), np.arange(1, 10)], 1)
    assert (tkcore.core_decompose(10, path, device="cpu") == 1).all()


@pytest.mark.parametrize("name,n,ce", GRAPHS, ids=IDS)
def test_sparsify_equal_reference(name, n, ce):
    for k in (3, 4, 5):
        np.testing.assert_array_equal(
            tsparsify.truss_filter(n, ce, k, device="cpu"),
            jsparsify.truss_filter(n, ce, k))
    if len(ce):
        te, tf = tsparsify.trussness_features(n, ce, device="cpu")
        je, jf = jsparsify.trussness_features(n, ce)
        np.testing.assert_array_equal(te, je)
        np.testing.assert_array_equal(tf, jf)
        assert tf.dtype == jf.dtype
        for alpha in (0.5, 1.0, 2.0):
            tw = tsparsify.sampling_weights(n, ce, alpha, device="cpu")
            jw = jsparsify.sampling_weights(n, ce, alpha)
            np.testing.assert_array_equal(tw, jw)
            assert tw.dtype == jw.dtype
    assert tsparsify.clique_upper_bound(n, ce, device="cpu") == \
        jsparsify.clique_upper_bound(n, ce)


@pytest.mark.parametrize("name,n,ce", GRAPHS, ids=IDS)
def test_peel_recompute_equals_reference(name, n, ce):
    g = tgraph.build_graph(n, ce)
    tris = jlist(jgraph.build_graph(n, ce))
    if len(tris) == 0:
        tris = np.full((1, 3), g.m, np.int32)   # the drop slot
    alive = np.ones(g.m, bool)
    want = np.asarray(jpeel.peel_recompute(tris, alive)) if g.m else \
        np.zeros(0, np.int32)
    s0 = tdevice.SYNCS
    phi = tpeel.peel_recompute(tris, alive, device="cpu")
    rounds = tdevice.SYNCS - s0 - 1   # one read a round, one that ends it
    np.testing.assert_array_equal(phi.numpy(), want)
    if g.m:
        np.testing.assert_array_equal(phi.numpy(),
                                      jpeel.truss_decompose(n, ce))
        assert rounds >= len(np.unique(want))


@pytest.mark.parametrize("name,n,ce", GRAPHS, ids=IDS)
def test_clustering_coefficient_equals_reference(name, n, ce):
    got = tgraph.clustering_coefficient(n, ce)
    assert isinstance(got, float)
    assert got == jgraph.clustering_coefficient(n, ce)


@pytest.mark.parametrize("name,n,ce", GRAPHS, ids=IDS)
def test_neighborhood_subgraph_and_subgraph_equal_reference(name, n, ce):
    tg, jg = tgraph.build_graph(n, ce), jgraph.build_graph(n, ce)
    rng = np.random.default_rng(5)
    for size in (1, max(1, n // 3), n):
        part = np.sort(rng.choice(n, size=size, replace=False))
        for got, want in zip(tgraph.neighborhood_subgraph(tg, part),
                             jgraph.neighborhood_subgraph(jg, part)):
            np.testing.assert_array_equal(got, want)
            assert got.dtype == want.dtype
    mask = rng.random(len(ce)) < 0.5
    np.testing.assert_array_equal(tg.subgraph(mask).edges,
                                  jg.subgraph(mask).edges)
