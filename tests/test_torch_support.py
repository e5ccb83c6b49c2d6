"""Triangle listing and edge supports of the PyTorch port against ``repro``.

Triangle lists are compared as SETS of edge-id triples (the two listings
emit rows in different orders); supports, incidence CSRs and wedge plans
exactly.  The port's device scan runs on the CPU here (``device="cpu"``).
"""

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import support as jsup
from repro_torch.core import graph as tgraph
from repro_torch.core import support as tsup
from tests.conftest import conformance_corpus, random_graph

torch.manual_seed(0)


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    rng = np.random.default_rng(11)
    out.append(("er200-dense", 200,
                jgraph.canonical_edges(random_graph(rng, 200, 0.3), 200)))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]


def _tri_set(tris):
    return {tuple(sorted(map(int, row))) for row in np.asarray(tris)}


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_triangle_lists_equal_as_sets(name, n, edges):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    ref = _tri_set(jsup.list_triangles_np(jg))
    for got in (tsup.list_triangles_np(tg), tsup.list_triangles(tg)):
        assert got.dtype == np.int32
        assert len(got) == len(ref)          # each triangle exactly once
        assert _tri_set(got) == ref
    assert _tri_set(tsup.list_triangles(tg, chunk=32, budget=256)) == ref
    np.testing.assert_array_equal(tsup.list_triangles_np(tg),
                                  jsup.list_triangles_np(jg))


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_supports_and_incidence_equal(name, n, edges):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    tris = jsup.list_triangles_np(jg)
    np.testing.assert_array_equal(tsup.support_from_triangle_list(tris, tg.m),
                                  jsup.support_from_triangle_list(tris, jg.m))
    np.testing.assert_array_equal(tsup.edge_support_np(tg),
                                  jsup.edge_support_np(jg))
    # incidence, also with padding rows on the drop slot m
    padded = np.concatenate([tris, np.full((5, 3), tg.m, np.int32)])
    for t in (tris, padded):
        for x, y in zip(tsup.triangle_incidence_np(t, tg.m),
                        jsup.triangle_incidence_np(t, jg.m)):
            np.testing.assert_array_equal(x, y)
    assert tsup.triangle_density(tg.m, len(tris)) == \
        jsup.triangle_density(jg.m, len(tris))


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_device_edge_support_equal_numpy(name, n, edges):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    want = jsup.edge_support_np(jg)
    got = tsup.edge_support(tg, device="cpu")
    assert got.dtype == torch.int32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # small chunks/budget: many scan steps, sentinel-padded buckets
    np.testing.assert_array_equal(
        tsup.edge_support(tg, chunk=64, budget=256, device="cpu").numpy(),
        want)


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_wedge_bucket_plan_equal(name, n, edges):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    tp, jp = tsup.wedge_bucket_plan(tg), jsup.wedge_bucket_plan(jg)
    assert len(tp) == len(jp)
    for a, b in zip(tp, jp):
        assert (a.n_real, a.D, a.chunk) == (b.n_real, b.D, b.chunk)
        np.testing.assert_array_equal(a.eids, b.eids)


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_edge_support_auto_both_branches_equal(name, n, edges):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    want = jsup.edge_support_auto(jg)
    got = tsup.edge_support_auto(tg, device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    verts, density = tsup.dense_core_stats(tg)
    jverts, jdensity = jsup.dense_core_stats(jg)
    np.testing.assert_array_equal(verts, jverts)
    assert density == jdensity
    # force the other branch: both must still equal the reference
    other = dict(dense_threshold=0.0) if density < 0.125 else \
        dict(dense_threshold=2.0)
    np.testing.assert_array_equal(
        tsup.edge_support_auto(tg, device="cpu", **other), want)


def test_dense_core_graph_takes_dense_branch(monkeypatch):
    """ER n = 200, p = 0.3 is a dense core: the dense-support path runs."""
    name, n, edges = GRAPHS[-1]
    _, density = tsup.dense_core_stats(tgraph.build_graph(n, edges))
    assert density >= 0.125
    calls = []
    from repro_torch.kernels.triangle_count import ops

    real = ops.dense_edge_support
    monkeypatch.setattr(ops, "dense_edge_support",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    got = tsup.edge_support_auto(tgraph.build_graph(n, edges), device="cpu")
    assert calls == [1]
    np.testing.assert_array_equal(
        got, jsup.edge_support_np(jgraph.build_graph(n, edges)))


def test_pow_ceilings_equal():
    for x in (0, 1, 2, 3, 5, 16, 17, 1000, 4097):
        assert tsup._pow2_ceil(x) == jsup._pow2_ceil(x)
        assert tsup._pow4_ceil(x) == jsup._pow4_ceil(x)


def test_empty_graph_supports():
    tg = tgraph.build_graph(4, np.zeros((0, 2)))
    assert tsup.edge_support(tg, device="cpu").shape == (0,)
    assert tsup.edge_support_auto(tg, device="cpu").shape == (0,)
    assert tsup.list_triangles(tg).shape == (0, 3)
    assert tsup.list_triangles_np(tg).shape == (0, 3)
