"""Budgeted top-down in the PyTorch port against ``repro``.

``partitioned_support`` (exact supports under a working-set budget) and the
budgeted ``top_down_decompose`` / ``truss_decompose(engine="top-down")``
must give the JAX package's answers exactly on the conformance corpus, at
several budgets, with the sequential and the random partitioner, and the
``OocStats`` counters both packages define the same way must be equal.
The port runs on the CPU (``device="cpu"``).
"""

import warnings

import numpy as np
import pytest

from repro.core import bottom_up as jbu
from repro.core import graph as jgraph
from repro.core import peel as jpeel
from repro.core import top_down as jtd
from repro.core.partition import PartitionBudgetWarning
from repro.core.serial import alg2_truss
from repro.core.support import edge_support_np, list_triangles_np
from repro_torch.core import bottom_up as tbu
from repro_torch.core import partition as tpart
from repro_torch.core import peel as tpeel
from repro_torch.core import top_down as ttd
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
PARTITIONERS = {"sequential": dict(partitioner="sequential"),
                "random0": dict(partitioner="random", partitioner_seed=0),
                "random3": dict(partitioner="random", partitioner_seed=3)}
BUDGETS = {"quarter": lambda m: max(8, m // 4), "eighth": lambda m: m // 8,
           "64": lambda m: 64}
SUPPORT_FIELDS = ("rounds", "scans", "batches", "parts", "tri_total",
                  "tri_assigned")
TOP_DOWN_FIELDS = SUPPORT_FIELDS + (
    "stage2_overlapped", "compiles", "retries", "degraded", "checkpoints",
    "resumed_round")


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PartitionBudgetWarning)
        warnings.simplefilter("ignore", tpart.PartitionBudgetWarning)
        return fn(*args, **kw)


def _assert_stats(t, j, fields, where):
    for f in fields:
        assert getattr(t, f) == getattr(j, f), (where, f)


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("part", list(PARTITIONERS))
@pytest.mark.parametrize("name,n,edges", CORPUS, ids=IDS)
def test_partitioned_support_equal(name, n, edges, part, budget):
    b = BUDGETS[budget](len(edges))
    kw = PARTITIONERS[part]
    want, jst = _quiet(jbu.partitioned_support, n, edges, b,
                       with_stats=True, **kw)
    got, tst = _quiet(tbu.partitioned_support, n, edges, b,
                      with_stats=True, **kw)
    np.testing.assert_array_equal(got, want)
    g = jgraph.build_graph(n, edges)
    np.testing.assert_array_equal(got, edge_support_np(g))
    # the docstring's invariant: every triangle credited exactly once
    assert int(got.sum()) == 3 * len(list_triangles_np(g))
    _assert_stats(tst, jst, SUPPORT_FIELDS, (name, part, budget))
    assert tst.rounds >= 1


@pytest.mark.parametrize("budget", list(BUDGETS))
@pytest.mark.parametrize("part", list(PARTITIONERS))
@pytest.mark.parametrize("name,n,edges", CORPUS, ids=IDS)
def test_budgeted_top_down_equal(name, n, edges, part, budget):
    b = BUDGETS[budget](len(edges))
    kw = PARTITIONERS[part]
    j = _quiet(jtd.top_down_decompose, n, edges, budget=b, **kw)
    t = _quiet(ttd.top_down_decompose, n, edges, budget=b, device="cpu",
               **kw)
    np.testing.assert_array_equal(t.phi, j.phi)
    np.testing.assert_array_equal(t.phi, alg2_truss(n, edges))
    assert (t.classes, t.kmax, t.candidate_sizes, t.pruned) == \
        (j.classes, j.kmax, j.candidate_sizes, j.pruned)
    _assert_stats(t.stats, j.stats, TOP_DOWN_FIELDS, (name, part, budget))


# top-t and the literal Procedure 8, as in test_torch_slice.TOP_DOWN_CASES,
# with a budget
CASES = [(c, "t2", dict(t=2)) for c in CORPUS[:2]] + \
        [(c, "faithful", dict(faithful_proc8=True)) for c in CORPUS[:2]]


@pytest.mark.parametrize("name,n,edges,kw", [(*c, kw) for c, _, kw in CASES],
                         ids=[f"{c[0]}-{i}" for c, i, _ in CASES])
def test_budgeted_top_down_options_equal(name, n, edges, kw):
    b = max(8, len(edges) // 4)
    j = _quiet(jtd.top_down_decompose, n, edges, budget=b, **kw)
    t = _quiet(ttd.top_down_decompose, n, edges, budget=b, device="cpu",
               **kw)
    np.testing.assert_array_equal(t.phi, j.phi)
    assert (t.classes, t.kmax, t.candidate_sizes, t.pruned) == \
        (j.classes, j.kmax, j.candidate_sizes, j.pruned)
    _assert_stats(t.stats, j.stats, TOP_DOWN_FIELDS, (name, kw))


@pytest.mark.parametrize("part", ["sequential", "random"])
@pytest.mark.parametrize("name,n,edges", CORPUS, ids=IDS)
def test_truss_decompose_top_down_equal(name, n, edges, part):
    mb = jpeel.estimate_working_set(jgraph.build_graph(n, edges)) // 4
    want, jst = _quiet(jpeel.truss_decompose, n, edges, engine="top-down",
                       memory_budget=mb, partitioner=part, with_stats=True)
    got, tst = _quiet(tpeel.truss_decompose, n, edges, engine="top-down",
                      memory_budget=mb, partitioner=part, with_stats=True,
                      device="cpu")
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    assert isinstance(tst, tbu.OocStats)
    _assert_stats(tst, jst, TOP_DOWN_FIELDS, (name, part))


def test_split_bucket_lanes_equal():
    """The lane split of the retry ladder: the same sub-buckets as the
    reference's, for batches built with and without incidence."""
    from repro.core import partition as jpart
    from repro_torch.core import graph as tgraph

    name, n, edges = CORPUS[1]
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    parts = _quiet(tpart.sequential_partition, tg, 16)
    for kw in (dict(), dict(with_incidence=False)):
        tb = tpart.build_partition_batch(tg, parts, **kw)
        jb = jpart.build_partition_batch(jg, parts, **kw)
        for tbk, jbk in zip(tb.buckets, jb.buckets):
            for factor in (1, 2, 3, 4, 64):
                ts = tpart.split_bucket_lanes(tbk, factor)
                js = jpart.split_bucket_lanes(jbk, factor)
                assert len(ts) == len(js)
                for a, b in zip(ts, js):
                    assert (a.n_lanes, a.n_parts, a.n_real_lanes,
                            a.real_edges) == (b.n_lanes, b.n_parts,
                                              b.n_real_lanes, b.real_edges)
                    for f in ("sup", "tris", "alive", "edge_ids",
                              "internal", "part_of"):
                        np.testing.assert_array_equal(getattr(a, f),
                                                      getattr(b, f))
                assert sum(s.n_lanes for s in ts) == tbk.n_lanes


def test_unported_support_arguments_raise():
    """``mesh`` still raises naming its ROADMAP item.  ``store=``,
    ``partitioner="locality"`` and ``engine="perpart"`` have been ported
    since and give the reference's supports and phi."""
    from repro.core.store import InMemoryStore as JInMemoryStore
    from repro_torch.core.store import InMemoryStore

    name, n, edges = CORPUS[0]
    with pytest.raises(NotImplementedError, match="A13"):
        tbu.partitioned_support(n, edges, 64, mesh=object())
    np.testing.assert_array_equal(
        tbu.partitioned_support(n, edges, 64, engine="perpart"),
        jbu.partitioned_support(n, edges, 64, engine="perpart"))
    with InMemoryStore() as store, JInMemoryStore() as jstore:
        np.testing.assert_array_equal(
            tbu.partitioned_support(n, edges, 64, store=store),
            jbu.partitioned_support(n, edges, 64, store=jstore))
    with pytest.raises(ValueError):
        tbu.partitioned_support(n, edges, 64, engine="bogus")
    with pytest.raises(NotImplementedError, match="A13"):
        ttd.top_down_decompose(n, edges, budget=64, device="cpu",
                               mesh=object())
    with InMemoryStore() as store, JInMemoryStore() as jstore:
        np.testing.assert_array_equal(
            ttd.top_down_decompose(n, edges, budget=64, device="cpu",
                                   store=store).phi,
            jtd.top_down_decompose(n, edges, budget=64, store=jstore).phi)
    np.testing.assert_array_equal(
        _quiet(ttd.top_down_decompose, n, edges, budget=64,
               partitioner="locality", device="cpu").phi,
        _quiet(jtd.top_down_decompose, n, edges, budget=64,
               partitioner="locality").phi)
