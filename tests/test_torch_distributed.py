"""The distributed module of the PyTorch port against ``repro``.

``repro_torch.core.distributed`` runs the reference's ``shard_map`` pieces
as ``torch.distributed`` ranks.  Its numpy helpers (padding, incidence
sharding) and the waste-aware lane packing of ``build_partition_batch``
(``lane_multiple``, ``shape_ladder``) are held array for array against the
reference's.  The sharded peels and the dense supports run on gloo ranks
(``tests/torch_mesh.py``: one spawn per mesh shape, (1,), (2,), (4,) and a
(2, 2) ("data", "tri") mesh) and are held against ``alg2_truss``, the
reference's single-device peels and ``edge_support_np``; the state every
rank replicates (phi, alive, the merged supports) must be equal on all of
them.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import distributed as jdist
from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.core import peel as jpeel
from repro.core.serial import alg2_truss
from repro.core.support import (edge_support_np, list_triangles,
                                support_from_triangle_list)
from repro.data import graphgen as jgen
from repro_torch.core import distributed as tdist
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from tests import torch_mesh
from tests.conftest import conformance_corpus

SHAPES = [(1,), (2,), (4,), (2, 2)]
SHAPE_IDS = ["1", "2", "4", "2x2"]


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = jgen.rmat(6, 6, seed=1)
    out.append(("rmat6", n, jgraph.canonical_edges(e, n)))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]


def _inputs(n, edges):
    g = jgraph.build_graph(n, edges)
    tris = np.asarray(list_triangles(g), np.int32).reshape(-1, 3)
    sup = support_from_triangle_list(tris, g.m).astype(np.int32)
    return g.m, sup, tris


def _quiet_parts(g, budget):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jpart.PartitionBudgetWarning)
        return jpart.sequential_partition(g, budget)


def _buckets(n, edges):
    g = jgraph.build_graph(n, edges)
    return jpart.build_partition_batch(
        g, _quiet_parts(g, max(16, g.m // 4))).buckets


def _parts(n, edges):
    """(sup, tris) of every NS part of one sequential round."""
    out = []
    for b in _buckets(n, edges):
        for lane in range(b.n_real_lanes):
            real = b.alive[lane]
            rows = b.tris[lane][(b.tris[lane] < b.cap_e).all(axis=1)]
            out.append((b.sup[lane][real], rows))
    return out


def _dense(n, edges):
    A = np.zeros((n, n), np.float32)
    A[edges[:, 0], edges[:, 1]] = A[edges[:, 1], edges[:, 0]] = 1
    return A


DENSE_N = 32


def _payload():
    graphs = []
    for name, n, edges in GRAPHS:
        m, sup, tris = _inputs(n, edges)
        rng = np.random.default_rng(m)
        graphs.append((name, m, sup, tris, rng.random(m) < 0.7,
                       int(rng.integers(0, 4))))
    name, n, edges = GRAPHS[1]
    er = jgraph.canonical_edges(
        np.random.default_rng(5).integers(0, DENSE_N, (120, 2)), DENSE_N)
    return dict(graphs=graphs,
                buckets=[(b.sup, b.tris, b.alive) for b in BUCKETS],
                parts=_parts(*GRAPHS[-1][1:]), A=_dense(DENSE_N, er), er=er)


BUCKETS = [b for _, n, e in GRAPHS[:2] + GRAPHS[-1:] for b in _buckets(n, e)]
PAYLOAD = _payload()


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every mesh shape's ranks, spawned once for the module."""
    return {shape: torch_mesh.spawn(
        "peels", shape, PAYLOAD, tmp_path_factory.mktemp("peels"))
        for shape in SHAPES}


# ---------------------------------------------------------------------------
# host helpers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev", [1, 2, 3, 4])
def test_pad_parts_equal(n_dev):
    parts = _parts(*GRAPHS[-1][1:])
    for a, b in zip(tdist.pad_parts(parts, n_dev),
                    jdist.pad_parts(parts, n_dev)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    for a, b in zip(tdist.pad_parts([], n_dev), jdist.pad_parts([], n_dev)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("n_dev", [1, 2, 4])
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_shard_incidence_and_caps_equal(name, n, edges, n_dev):
    m, _, tris = _inputs(n, edges)
    tp = tdist.pad_triangles(tris, m, n_dev)
    np.testing.assert_array_equal(tp, jdist.pad_triangles(tris, m, n_dev))
    assert len(tp) % n_dev == 0 and len(tp) >= max(len(tris), 1)
    got = tdist.shard_incidence(tp, m, n_dev)
    want = jdist.shard_incidence(tp, m, n_dev)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for caps in ((None, None), (64, 8), (None, 4096)):
        assert tdist._sharded_caps(m, *got, *caps) == \
            jdist._sharded_caps(m, *want, *caps)


@pytest.mark.parametrize("n_shards", [1, 2, 4])
def test_pad_bucket_lanes_and_shard_lanes_equal(n_shards):
    for b in _buckets(*GRAPHS[-1][1:]):
        for n_lanes in (b.n_lanes, b.n_lanes + 3):
            args = (b.sup, b.tris, b.indptr, b.tids, b.alive, n_lanes)
            got = tdist.pad_bucket_lanes(*args)
            for a, w in zip(got, jdist.pad_bucket_lanes(*args)):
                np.testing.assert_array_equal(a, w)
            lean = tdist.pad_bucket_lanes(b.sup, b.tris, None, None, b.alive,
                                          n_lanes)
            assert lean[2] is None and lean[3] is None
            for i in (0, 1, 4):
                np.testing.assert_array_equal(lean[i], got[i])
        T = -(-b.cap_t // n_shards) * n_shards
        tris = np.concatenate([b.tris, np.full(
            (b.n_lanes, T - b.cap_t, 3), b.cap_e, np.int32)], axis=1)
        for a, w in zip(tdist.shard_incidence_lanes(tris, b.cap_e, n_shards),
                        jdist.shard_incidence_lanes(tris, b.cap_e,
                                                    n_shards)):
            np.testing.assert_array_equal(a, w)


def test_axes_and_round_up_equal():
    for axis in ("data", ("data", "tri"), ["tri"]):
        assert tdist._axes_tuple(axis) == jdist._axes_tuple(axis)
    for count in range(0, 40):
        for multiple in (1, 2, 3, 4, 8):
            assert tpart.round_up_to_multiple(count, multiple) == \
                jpart.round_up_to_multiple(count, multiple)


@pytest.mark.parametrize("lane_multiple", [1, 2, 4])
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_waste_aware_batches_equal(name, n, edges, lane_multiple):
    """``lane_multiple`` and the shape ladder pack as the reference does;
    ``lane_multiple=1`` is the default packing, byte for byte."""
    from tests.test_torch_partition import _assert_same_batch

    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    ladder = []
    for budget in (max(16, tg.m // 3), max(16, tg.m // 6), tg.m + 1):
        parts = _quiet_parts(jg, budget)
        if not parts:
            continue
        kw = dict(lane_multiple=lane_multiple,
                  shape_ladder=ladder if lane_multiple > 1 else None)
        tb = tpart.build_partition_batch(tg, parts, **kw)
        _assert_same_batch(tb, jpart.build_partition_batch(jg, parts, **kw),
                           (name, budget))
        if lane_multiple == 1:
            _assert_same_batch(tb, jpart.build_partition_batch(jg, parts),
                               (name, budget, "default"))
        for b in tb.buckets:
            assert b.n_lanes % lane_multiple == 0
            if (b.cap_e, b.cap_t, b.n_lanes) not in ladder:
                ladder.append((b.cap_e, b.cap_t, b.n_lanes))


# ---------------------------------------------------------------------------
# the sharded peels and dense supports on gloo ranks
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_peel_classes_sharded(ranks, shape, name, n, edges):
    """phi bit-equal to ``alg2_truss`` and to the reference's single-device
    phi on every rank; the merged supports equal on every rank."""
    want = alg2_truss(n, edges)
    np.testing.assert_array_equal(want, jpeel.truss_decompose(n, edges))
    for r, res in enumerate(ranks[shape]):
        got = res["graphs"][name]
        np.testing.assert_array_equal(got["phi"], want, err_msg=str(r))
        np.testing.assert_array_equal(got["phi_rounds"], want)
        np.testing.assert_array_equal(got["sup"],
                                      ranks[shape][0]["graphs"][name]["sup"])


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_local_threshold_peel_sharded(ranks, shape, name, n, edges):
    """The level peel's alive mask equals the reference's single-device
    one on every rank; alive and the merged supports are replicated."""
    gname, m, sup, tris, removable, thresh = \
        PAYLOAD["graphs"][IDS.index(name)]
    want, _, _ = jpeel.local_threshold_peel(sup, tris, removable, thresh)
    want = np.asarray(want)
    first = ranks[shape][0]["graphs"][name]
    for res in ranks[shape]:
        got = res["graphs"][name]
        np.testing.assert_array_equal(got["alive"], want)
        np.testing.assert_array_equal(got["alive_rounds"], want)
        np.testing.assert_array_equal(got["sup_t"], first["sup_t"])
    # the surviving supports count the surviving triangles exactly
    alive = want
    live = alive[tris].all(axis=1) if len(tris) else np.zeros(0, bool)
    np.testing.assert_array_equal(
        np.where(alive, first["sup_t"], 0),
        np.where(alive, support_from_triangle_list(tris[live], m), 0))


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_peel_classes_batched_sharded(ranks, shape):
    """Every bucket's lanes split over the lane axis (and, on the (2, 2)
    mesh, each lane's rows over "tri"): the reference's single-device phi
    on every rank."""
    for i, b in enumerate(BUCKETS):
        want, _, _ = jpeel.peel_classes_batched(b.sup, b.tris, b.indptr,
                                                b.tids, b.alive)
        for res in ranks[shape]:
            got = res["buckets"][i]
            assert got["phi"].shape == b.sup.shape
            np.testing.assert_array_equal(got["phi"], np.asarray(want))
            assert got["stats"].shape == (b.n_lanes, 4)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_distributed_local_truss(ranks, shape):
    """Each part's local trussness, the parts split over "data", equals the
    reference's on a one-device mesh."""
    import jax

    n_dev = shape[0]
    jmesh = jax.make_mesh((1,), ("data",), devices=jax.devices()[:1])
    want = np.asarray(jdist.distributed_local_truss(
        jmesh, *jdist.pad_parts(PAYLOAD["parts"], n_dev)))
    for res in ranks[shape]:
        np.testing.assert_array_equal(res["local_truss"], want)


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_dense_supports(ranks, shape):
    """The ring's S equals the all-gather's and ``edge_support_np`` on every
    edge, and is zero off the edges."""
    er = PAYLOAD["er"]
    g = jgraph.build_graph(DENSE_N, er)
    want = edge_support_np(g)
    A = PAYLOAD["A"]
    for res in ranks[shape]:
        np.testing.assert_array_equal(res["ring"], res["allgather"])
        np.testing.assert_array_equal(res["ring"][er[:, 0], er[:, 1]], want)
        np.testing.assert_array_equal(res["ring"][er[:, 1], er[:, 0]], want)
        assert (res["ring"][A == 0] == 0).all()


@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_collectives_run_at_every_size(ranks, shape):
    """Every piece meets the other ranks, a one-rank mesh included."""
    for res in ranks[shape]:
        assert res["collectives"] > res["collectives0"] >= 0
        assert res["collectives"] >= 4 * len(PAYLOAD["graphs"])


def test_one_rank_mesh_in_process(tmp_path):
    """A (1, 1) mesh in this process: the flattened axes, the sharded peel
    over both names, and both dense supports."""
    with torch_mesh.one_rank_mesh(tmp_path, (1, 1)) as mesh:
        assert tdist.axis_size(mesh, ("data", "tri")) == 1
        assert tdist.axis_index(mesh, ("data", "tri")) == 0
        assert tdist.mesh_devices(mesh, ("data", "tri")) == 1
        assert tdist.mesh_devices(None, "data") == 1
        m, sup, tris = _inputs(*GRAPHS[0][1:])
        phi = tdist.peel_classes_sharded(mesh, sup, tris, np.ones(m, bool),
                                         axis=("data", "tri"), device="cpu")
        np.testing.assert_array_equal(phi.numpy(), alg2_truss(*GRAPHS[0][1:]))
        A = PAYLOAD["A"]
        c0 = tdist.COLLECTIVES
        ring = tdist.ring_support_dense(mesh, A, device="cpu")
        assert tdist.COLLECTIVES - c0 == 2      # one ring step, one gather
        torch.testing.assert_close(
            ring, tdist.allgather_support_dense(mesh, A, device="cpu"),
            rtol=0, atol=0)
