"""Peel engines of the PyTorch port against ``repro.core.peel``.

The frontier and dense engines run on CPU tensors (``device="cpu"``) and
must equal the JAX engines in phi, alive and — for the frontier engine —
every ``PeelStats`` field, also with a ``cap_t`` small enough to force
capacity-doubling resumes.  The batched local peels run on partition
buckets that the JAX ``build_partition_batch`` made, carried across by
``interop``.  All comparisons are exact.  The batched peels upload only
real triangle rows (a candidate's ``T`` rows and ``m`` edges, a bucket's
rows up to each lane's last real one) while the ``compiles`` counter keeps
the reference's pow4 launch shapes.
"""

import warnings

import numpy as np
import pytest
import torch

from repro.core import bottom_up as jbu
from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.core import peel as jpeel
from repro.core import top_down as jtd
from repro.core.support import list_triangles_np, support_from_triangle_list
from repro.data import graphgen as jgen
from repro_torch import interop
from repro_torch.core import bottom_up as tbu
from repro_torch.core import graph as tgraph
from repro_torch.core import peel as tpeel
from repro_torch.core import top_down as ttd
from repro_torch.kernels.frontier_peel import ops as tops
from tests.conftest import conformance_corpus

torch.manual_seed(0)


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = jgen.rmat(8, 6, seed=2)
    out.append(("rmat8", n, e))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]


def _inputs(n, edges):
    g = jgraph.build_graph(n, edges)
    tris = list_triangles_np(g)
    sup = support_from_triangle_list(tris, g.m).astype(np.int32)
    if len(tris) == 0:
        tris = np.full((1, 3), g.m, np.int32)
    return g.m, sup, tris


def _np(x):
    return x.cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


# the default capacities on every graph; a cap_t below the largest
# incidence row on the two power-law graphs, forcing resumes
FRONTIER_CASES = [(g, None) for g in GRAPHS] + [(GRAPHS[1], 4),
                                                (GRAPHS[-1], 16)]


@pytest.mark.parametrize(
    "name,n,edges,cap_t", [(*g, c) for g, c in FRONTIER_CASES],
    ids=[f"{g[0]}-{c}" for g, c in FRONTIER_CASES])
def test_peel_classes_frontier_equal(name, n, edges, cap_t):
    m, sup, tris = _inputs(n, edges)
    alive0 = np.ones(m, bool)
    alive0[::7] = False
    sup = support_from_triangle_list(
        tris[alive0[np.minimum(tris, m - 1)].all(axis=1) & (tris < m).all(1)],
        m).astype(np.int32)
    jphi, jalive, jst = jpeel.peel_classes(sup, tris, alive0, cap_t=cap_t,
                                           with_stats=True)
    tphi, talive, tst = tpeel.peel_classes(sup, tris, alive0, cap_t=cap_t,
                                           with_stats=True, device="cpu")
    np.testing.assert_array_equal(_np(tphi), _np(jphi))
    np.testing.assert_array_equal(_np(talive), _np(jalive))
    assert tst == tpeel.PeelStats(**vars(jst)), name
    if cap_t is not None:
        assert tst.resumes > 0               # the doubling path ran


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_peel_classes_dense_and_max_k_equal(name, n, edges):
    m, sup, tris = _inputs(n, edges)
    ones = np.ones(m, bool)
    for max_k in (None, 3):
        jphi, jalive = jpeel.peel_classes(sup, tris, ones, max_k=max_k,
                                          engine="dense")
        for engine in ("dense", "frontier"):
            tphi, talive = tpeel.peel_classes(sup, tris, ones, max_k=max_k,
                                              engine=engine, device="cpu")
            np.testing.assert_array_equal(_np(tphi), _np(jphi))
            np.testing.assert_array_equal(_np(talive), _np(jalive))
    assert tpeel.peel_classes(sup, tris, ones, engine="dense",
                              with_stats=True, device="cpu")[2] is None


@pytest.mark.parametrize("cap_t", [None, 16])
@pytest.mark.parametrize("name,n,edges", GRAPHS[:1] + GRAPHS[-1:],
                         ids=IDS[:1] + IDS[-1:])
def test_peel_threshold_equal(name, n, edges, cap_t):
    m, sup, tris = _inputs(n, edges)
    rng = np.random.default_rng(m)
    removable = rng.random(m) < 0.6
    ones = np.ones(m, bool)
    for thresh in (0, 2):
        ja, js, jr, jst = jpeel.peel_threshold(
            sup, tris, ones, removable, thresh, cap_t=cap_t, with_stats=True)
        ta, ts, tr, tst = tpeel.peel_threshold(
            sup, tris, ones, removable, thresh, cap_t=cap_t, with_stats=True,
            device="cpu")
        for a, b in ((ta, ja), (ts, js), (tr, jr)):
            np.testing.assert_array_equal(_np(a), _np(b))
        assert tst == tpeel.PeelStats(**vars(jst))
        ja, js, jr = jpeel.peel_threshold(sup, tris, ones, removable, thresh,
                                          engine="dense")
        ta, ts, tr = tpeel.peel_threshold(sup, tris, ones, removable, thresh,
                                          engine="dense", device="cpu")
        for a, b in ((ta, ja), (ts, js), (tr, jr)):
            np.testing.assert_array_equal(_np(a), _np(b))


def _jax_buckets(n, edges, kind):
    g = jgraph.build_graph(n, edges)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jpart.PartitionBudgetWarning)
        parts = (jpart.random_partition(g, g.m // 3, seed=1)
                 if kind == "random" else
                 jpart.sequential_partition(g, g.m // 3))
    return jpart.build_partition_batch(g, parts).buckets


@pytest.mark.parametrize("kind", ["sequential", "random"])
def test_peel_classes_batched_equal(kind):
    name, n, edges = GRAPHS[-1]
    cache_t, cache_j = set(), set()
    for jb in _jax_buckets(n, edges, kind):
        tb = interop.part_bucket(jb)
        jphi, jst, jnew = jpeel.peel_classes_batched(
            jb.sup, jb.tris, jb.indptr, jb.tids, jb.alive,
            shape_cache=cache_j)
        tphi, tst, tnew = tpeel.peel_classes_batched(
            tb.sup, tb.tris, tb.alive, shape_cache=cache_t, device="cpu")
        np.testing.assert_array_equal(tphi, np.asarray(jphi))
        assert tnew == jnew
        # the fused-round stats; the JAX kernel route pads T to its tile,
        # so its gathered column counts 3 * T_pad where the port counts 3T
        jphi_k, jst_k, _ = jpeel.peel_classes_batched(
            jb.sup, jb.tris, jb.indptr, jb.tids, jb.alive, kernel="pallas")
        np.testing.assert_array_equal(tphi, np.asarray(jphi_k))
        jst_k = np.asarray(jst_k)
        for col in (0, 1, 3):
            np.testing.assert_array_equal(tst[:, col], jst_k[:, col])
        assert ((tst[:, 2] > 0) == (jst_k[:, 2] > 0)).all()
        assert (tst[:, 2] % (3 * jb.cap_t) == 0).all()


def test_peel_classes_batched_triangle_free_and_pending():
    n, edges = 12, np.stack([np.arange(11), np.arange(1, 12)], 1)
    jb = _jax_buckets(n, edges, "sequential")[0]
    h = tpeel.peel_classes_batched(jb.sup, jb.tris, jb.alive, blocking=False,
                                   device="cpu")
    phi, st = h.result()
    assert h.result() is h.result()               # cached
    np.testing.assert_array_equal(phi, np.where(jb.alive, 2, 0))
    assert not st.any() and not h.new_compile


@pytest.mark.parametrize("thresh", [0, 1, 3])
def test_local_threshold_peel_equal(thresh):
    name, n, edges = GRAPHS[-1]
    m, sup, tris = _inputs(n, edges)
    rng = np.random.default_rng(thresh)
    removable = rng.random(m) < 0.7
    alive0 = rng.random(m) < 0.9
    t_alive = alive0[tris].all(axis=1)
    sup = support_from_triangle_list(tris[t_alive], m).astype(np.int32)
    ja, jr, _ = jpeel.local_threshold_peel(sup, tris, removable, thresh,
                                           alive0=alive0)
    ta, tr, new = tpeel.local_threshold_peel(sup, tris, removable, thresh,
                                             alive0=alive0, device="cpu")
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tr, np.asarray(jr))
    # no triangles: the one-sweep host short cut
    ja, jr, _ = jpeel.local_threshold_peel(sup, tris[:0], removable, thresh)
    ta, tr, _ = tpeel.local_threshold_peel(sup, tris[:0], removable, thresh,
                                           device="cpu")
    np.testing.assert_array_equal(ta, ja)
    np.testing.assert_array_equal(tr, jr)


def test_pending_peel_poisons_after_failure():
    calls = []

    def boom():
        calls.append(1)
        raise ValueError("device failure")

    h = tpeel.PendingPeel(boom, True)
    with pytest.raises(ValueError):
        h.result()
    with pytest.raises(RuntimeError):
        h.result()
    assert calls == [1]


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_estimate_working_set_equal(name, n, edges):
    assert tpeel.estimate_working_set(tgraph.build_graph(n, edges)) == \
        jpeel.estimate_working_set(jgraph.build_graph(n, edges))


def test_support_from_triangles_equal():
    name, n, edges = GRAPHS[-1]
    m, _, tris = _inputs(n, edges)
    alive = np.random.default_rng(0).random(m) < 0.8
    want = jpeel.support_from_triangles(tris, alive, m)
    got = tpeel.support_from_triangles(torch.as_tensor(tris).long(),
                                       torch.as_tensor(alive), m)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _spy(monkeypatch, name):
    """Record the tensors handed to ``frontier_peel.ops.<name>``."""
    calls = []
    real = getattr(tops, name)

    def spy(*args, **kw):
        calls.append((args, kw))
        return real(*args, **kw)

    monkeypatch.setattr(tops, name, spy)
    return calls


@pytest.mark.parametrize("thresh", [0, 2])
def test_local_threshold_peel_uploads_real_rows_only(monkeypatch, thresh):
    name, n, edges = GRAPHS[-1]
    m, sup, tris = _inputs(n, edges)
    assert tpeel._pow4_ceil(len(tris)) > len(tris)    # padding was possible
    removable = np.random.default_rng(thresh).random(m) < 0.7
    calls = _spy(monkeypatch, "peel_threshold_fused")
    cache = set()
    ta, tr, new = tpeel.local_threshold_peel(sup, tris, removable, thresh,
                                             shape_cache=cache, device="cpu")
    (args, _), = calls
    assert tuple(args[1].shape) == (len(tris), 3)       # T rows, unpadded
    assert tuple(args[0].shape) == tuple(args[2].shape) == \
        tuple(args[4].shape) == (m,)                   # m edges, unpadded
    np.testing.assert_array_equal(args[1].numpy(), tris)
    # the launch shape the compiles counter sees is the reference's pow4 key
    assert new and cache == {(tpeel._pow4_ceil(m),
                              tpeel._pow4_ceil(len(tris)))}
    ja, jr, _ = jpeel.local_threshold_peel(sup, tris, removable, thresh)
    np.testing.assert_array_equal(ta, np.asarray(ja))
    np.testing.assert_array_equal(tr, np.asarray(jr))


def test_peel_classes_batched_uploads_rows_to_last_real_row(monkeypatch):
    name, n, edges = GRAPHS[-1]
    calls = _spy(monkeypatch, "peel_classes_fused")
    for jb in _jax_buckets(n, edges, "sequential"):
        tb = interop.part_bucket(jb)
        calls.clear()
        tphi, tst, _ = tpeel.peel_classes_batched(tb.sup, tb.tris, tb.alive,
                                                  device="cpu")
        if not calls:                        # triangle-free short cut
            continue
        (args, kw), = calls
        real = (tb.tris < tb.cap_e).all(axis=2).sum(axis=1)
        np.testing.assert_array_equal(kw["n_rows"].numpy(), real)
        assert args[1].shape[1] == max(int(real.max()), 1) <= tb.cap_t
        assert kw["cap_t"] == tb.cap_t
        jphi, jst, _ = jpeel.peel_classes_batched(
            jb.sup, jb.tris, jb.indptr, jb.tids, jb.alive)
        np.testing.assert_array_equal(tphi, np.asarray(jphi))


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_ooc_compiles_and_top_down_stats_equal(name, n, edges):
    """With the unpadded uploads, ``OocStats.compiles`` still counts the
    reference's launch shapes, and top-down's stats equal the reference's."""
    budget = max(64, len(edges) // 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jbu.bottom_up_decompose(n, edges, budget)
        t = tbu.bottom_up_decompose(n, edges, budget, device="cpu")
    np.testing.assert_array_equal(t.phi, j.phi)
    assert t.stats.compiles == j.stats.compiles
    j = jtd.top_down_decompose(n, edges)
    t = ttd.top_down_decompose(n, edges, device="cpu")
    np.testing.assert_array_equal(t.phi, j.phi)
    for f in ("compiles", "scans", "batches", "stage2_overlapped"):
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)
