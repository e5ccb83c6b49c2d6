"""Partitioners and partition batches of the PyTorch port against ``repro``.

Host numpy on both sides: every part and every ``PartBucket`` field must be
equal, for the sequential and random partitioners, with the triangle list
enumerated by ``build_partition_batch`` itself or passed in (the
incremental round path).
"""

import dataclasses
import warnings

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.core.support import list_triangles
from repro.data import graphgen as jgen
from repro_torch import interop
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from tests.conftest import conformance_corpus

torch.manual_seed(0)


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = jgen.rmat(9, 6, seed=1)
    out.append(("rmat9", n, e))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]
BUCKET_FIELDS = [f.name for f in dataclasses.fields(jpart.PartBucket)]


def _parts(module, g, kind, budget, seed):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", module.PartitionBudgetWarning)
        if kind == "random":
            return module.random_partition(g, budget, seed=seed)
        return module.sequential_partition(g, budget)


def _assert_same_batch(tb, jb, tag):
    for f in ("n_parts", "real_edges", "padded_slots", "max_part_edges",
              "tri_total", "tri_assigned", "tri_est"):
        assert getattr(tb, f) == getattr(jb, f), (tag, f)
    assert tb.tri_locality == jb.tri_locality, tag
    assert len(tb.buckets) == len(jb.buckets), tag
    for tbk, jbk in zip(tb.buckets, jb.buckets):
        for f in BUCKET_FIELDS:
            a, b = getattr(tbk, f), getattr(jbk, f)
            if isinstance(b, np.ndarray):
                assert a.dtype == b.dtype, (tag, f)
                np.testing.assert_array_equal(a, b, err_msg=f"{tag} {f}")
            else:
                assert a == b, (tag, f)
        assert tbk.n_lanes == jbk.n_lanes
        assert tbk.padded_slots == jbk.padded_slots


@pytest.mark.parametrize("kind", ["sequential", "random"])
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_partition_batch_fields_equal(name, n, edges, kind):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    budget = max(16, tg.m // 3)
    tparts = _parts(tpart, tg, kind, budget, seed=3)
    jparts = _parts(jpart, jg, kind, budget, seed=3)
    assert len(tparts) == len(jparts)
    for a, b in zip(tparts, jparts):
        np.testing.assert_array_equal(a, b)
    if not tparts:
        return
    _assert_same_batch(tpart.build_partition_batch(tg, tparts),
                       jpart.build_partition_batch(jg, jparts), name)
    # a precomputed full-graph list (the incremental round path)
    tris = np.asarray(list_triangles(jg), np.int64).reshape(-1, 3)
    _assert_same_batch(tpart.build_partition_batch(tg, tparts, tris=tris),
                       jpart.build_partition_batch(jg, jparts, tris=tris),
                       name + " tris")
    # a partial cover scopes the enumeration to the NS union
    half = tparts[: max(1, len(tparts) // 2)]
    _assert_same_batch(tpart.build_partition_batch(tg, half),
                       jpart.build_partition_batch(jg, half), name + " half")


@pytest.mark.parametrize("name,n,edges", GRAPHS[-2:], ids=IDS[-2:])
def test_batch_options_equal(name, n, edges):
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    parts = _parts(tpart, tg, "sequential", max(16, tg.m // 4), 0)
    for kw in (dict(with_incidence=False), dict(pad_lanes_pow2=False),
               dict(lane_capacity=64)):
        _assert_same_batch(tpart.build_partition_batch(tg, parts, **kw),
                           jpart.build_partition_batch(jg, parts, **kw),
                           f"{name} {kw}")
    with pytest.raises(ValueError):
        tpart.build_partition_batch(tg, parts, lane_capacity=0)


def test_ns_edge_lists_and_assignment_equal():
    name, n, edges = GRAPHS[-1]
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    parts = _parts(tpart, tg, "random", tg.m // 5, 1)
    for (a, b), (c, d) in zip(tpart.ns_edge_lists(tg, parts),
                              jpart.ns_edge_lists(jg, parts)):
        np.testing.assert_array_equal(a, c)
        np.testing.assert_array_equal(b, d)
    part_of = np.full(n, -1, np.int64)
    for i, P in enumerate(parts):
        part_of[P] = i
    tris = np.asarray(list_triangles(jg), np.int64).reshape(-1, 3)
    np.testing.assert_array_equal(tpart.assign_triangles(tg, tris, part_of),
                                  jpart.assign_triangles(jg, tris, part_of))


def test_over_budget_vertex_warns_like_reference():
    name, n, edges = GRAPHS[2]          # star-hub: one vertex above budget
    tg = tgraph.build_graph(n, edges)
    for fn in (tpart.sequential_partition,
               lambda g, b: tpart.random_partition(g, b, seed=0)):
        with pytest.warns(tpart.PartitionBudgetWarning):
            parts = fn(tg, 8)
        assert sum(len(p) for p in parts) == int((tg.deg > 0).sum())


def test_interop_bucket_carries_every_field():
    name, n, edges = GRAPHS[-1]
    jg = jgraph.build_graph(n, edges)
    jb = jpart.build_partition_batch(jg, jpart.sequential_partition(
        jg, jg.m // 4)).buckets[0]
    tb = interop.part_bucket(jb)
    for f in BUCKET_FIELDS:
        a, b = getattr(tb, f), getattr(jb, f)
        if isinstance(b, np.ndarray):
            np.testing.assert_array_equal(a, b)
        else:
            assert a == b
    ts = interop.bucket_tensors(tb, device="cpu")
    assert ts["tris"].shape == jb.tris.shape
    assert all(t.dtype == torch.int32 for t in ts.values())
