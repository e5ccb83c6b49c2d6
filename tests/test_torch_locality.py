"""The locality partitioner of the port against ``repro``'s.

Mirrors the partitioner cases of ``tests/test_locality_ooc.py`` and the
zone-state cases of ``tests/test_resume.py``: ``locality_partition`` must
return the reference's parts array for array (conformance corpus and R-MAT
scale 10, three budgets, four ``prev_locality`` values), as must its
helpers; the chunk-streamed batch build must equal the reference's; and
bottom-up, ``partitioned_support`` and budgeted top-down with
``partitioner="locality"`` must give the reference's phi and shared
``OocStats`` counters, across an interruption and resume too (the zone
state is journaled and restored).  The port runs on the CPU.
"""

import contextlib
import warnings

import numpy as np
import pytest

from repro.core import bottom_up as jbu
from repro.core import faults as jfaults
from repro.core import graph as jgraph
from repro.core import partition as jpart
from repro.core import store as jstore
from repro.core import top_down as jtd
from repro.data import graphgen as jgen
from repro_torch.core import bottom_up as tbu
from repro_torch.core import faults
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from repro_torch.core import store as tstore
from repro_torch.core import top_down as ttd
from tests.conftest import conformance_corpus, star_hub_graph


def _graphs():
    out = list(conformance_corpus())
    n, e = jgen.rmat(10, 8, seed=5)
    out.append(("rmat10", n, e))
    return out


GRAPHS = _graphs()
IDS = [g[0] for g in GRAPHS]
CORPUS = GRAPHS[:-1]
SHARED = ("rounds", "scans", "batches", "parts", "tri_total",
          "tri_assigned", "tri_est", "tri_rescans_avoided")


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", jpart.PartitionBudgetWarning)
        warnings.simplefilter("ignore", tpart.PartitionBudgetWarning)
        yield


def _assert_stats(t, j, fields, where):
    for f in fields:
        assert getattr(t, f) == getattr(j, f), (where, f, getattr(t, f),
                                                getattr(j, f))


def _budgets(m):
    return sorted({b for b in (max(8, m // 4), m // 8, 64) if b > 0})


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_locality_partition_parts_equal(name, n, edges):
    jg, tg = jgraph.build_graph(n, edges), tgraph.build_graph(n, edges)
    for budget in _budgets(jg.m):
        for prev in (None, 0.0, 0.5, 1.0):
            with _quiet():
                want = jpart.locality_partition(jg, budget, prev)
                got = tpart.locality_partition(tg, budget, prev)
            where = (name, budget, prev)
            assert len(got) == len(want), where
            for a, b in zip(got, want):
                assert a.dtype == b.dtype, where
                np.testing.assert_array_equal(a, b, err_msg=str(where))


def test_zone_mult_and_constants_equal():
    for prev in (None, -1.0, 0.0, 0.25, 0.5, 0.9, 1.0, 2.0):
        assert tpart._zone_mult(prev) == jpart._zone_mult(prev), prev
    for c in ("_ZONE_BUDGET_MULT", "_ZONE_FRACTION", "_ZONE_MULT_MIN",
              "_ZONE_MULT_MAX"):
        assert getattr(tpart, c) == getattr(jpart, c), c
    assert set(tpart.PARTITIONERS) == set(jpart.PARTITIONERS)


def test_first_fit_decreasing_2d_equal():
    rng = np.random.default_rng(11)
    cases = [([30, 30, 30, 30, 5, 5, 5, 5], [1000] * 4 + [0] * 4, 70, 10),
             ([60, 60, 5, 5], [10, 10, 40, 40], 70, 50),
             ([], [], 10, 10)]
    for _ in range(40):
        k = int(rng.integers(1, 30))
        cases.append((rng.integers(1, 50, k).tolist(),
                      rng.integers(0, 200, k).tolist(),
                      int(rng.integers(20, 120)), int(rng.integers(1, 400))))
    for costs, tris, cap_c, cap_t in cases:
        got = tpart._first_fit_decreasing_2d(costs, tris, cap_c, cap_t)
        assert got == jpart._first_fit_decreasing_2d(costs, tris, cap_c,
                                                     cap_t)
        assert sorted(i for b in got for i in b) == list(range(len(costs)))


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_undirected_csr_equal(name, n, edges):
    got = tgraph.undirected_csr(tgraph.build_graph(n, edges))
    want = jgraph.undirected_csr(jgraph.build_graph(n, edges))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(a, b)


def test_locality_partition_warns_on_hub():
    n, ce = star_hub_graph(30, 29)
    out = []
    for glib, plib in ((jgraph, jpart), (tgraph, tpart)):
        with pytest.warns(plib.PartitionBudgetWarning) as rec:
            parts = plib.locality_partition(glib.build_graph(n, ce), budget=5)
        msg = rec[0].message
        assert msg.max_cost == n - 1
        allv = np.concatenate(parts)
        assert len(allv) == len(np.unique(allv))   # no vertex twice
        out.append(((msg.n_over, msg.budget, msg.max_cost), parts))
    assert out[0][0] == out[1][0]
    assert all((a == b).all() for a, b in zip(out[0][1], out[1][1]))


@pytest.mark.parametrize("name,n,edges", CORPUS[:4], ids=IDS[:4])
def test_chunk_streamed_batch_equal(tmp_path, name, n, edges):
    """``build_partition_batch`` fed the triangle list as store chunks
    equals the reference's on the same chunks (unassigned rows dropped,
    ``tri_peak_rows`` counted)."""
    jg, tg = jgraph.build_graph(n, edges), tgraph.build_graph(n, edges)
    budget = max(8, jg.m // 4)
    with _quiet():
        parts = jpart.locality_partition(jg, budget)
    from repro.core.support import list_triangles

    tris = np.asarray(list_triangles(jg), np.int64).reshape(-1, 3)
    out = []
    for smod, plib, g in ((jstore, jpart, jg), (tstore, tpart, tg)):
        with smod.ChunkedDiskStore(str(tmp_path / plib.__name__),
                                   chunk_bytes=96) as store:
            store.put("g1/tris", tris)
            out.append(plib.build_partition_batch(
                g, parts, tris=store.get_chunks("g1/tris")))
    tb, jb = out[1], out[0]
    for f in ("n_parts", "real_edges", "padded_slots", "max_part_edges",
              "tri_total", "tri_assigned", "tri_est", "tri_peak_rows"):
        assert getattr(tb, f) == getattr(jb, f), (name, f)
    assert (0 < tb.tri_peak_rows <= len(tris)) or not len(tris)
    assert len(tb.buckets) == len(jb.buckets)
    for a, b in zip(tb.buckets, jb.buckets):
        for f in ("sup", "tris", "alive", "indptr", "tids", "edge_ids",
                  "internal", "part_of"):
            np.testing.assert_array_equal(getattr(a, f), getattr(b, f))


@pytest.mark.parametrize("engine", ["bottom-up", "top-down", "support"])
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_locality_drivers_equal(engine, name, n, edges):
    """phi (or sup) and the shared ``OocStats`` counters of bottom-up,
    budgeted top-down and ``partitioned_support`` with the locality
    partitioner equal the reference's."""
    budget = max(8, len(tgraph.canonical_edges(edges, n)) // 4)
    with _quiet():
        if engine == "bottom-up":
            j = jbu.bottom_up_decompose(n, edges, budget, "locality")
            t = tbu.bottom_up_decompose(n, edges, budget, "locality",
                                        device="cpu")
            j_out, t_out, js, ts = j.phi, t.phi, j.stats, t.stats
        elif engine == "top-down":
            j = jtd.top_down_decompose(n, edges, budget=budget,
                                       partitioner="locality")
            t = ttd.top_down_decompose(n, edges, budget=budget,
                                       partitioner="locality", device="cpu")
            j_out, t_out, js, ts = j.phi, t.phi, j.stats, t.stats
        else:
            j_out, js = jbu.partitioned_support(n, edges, budget, "locality",
                                                with_stats=True)
            t_out, ts = tbu.partitioned_support(n, edges, budget, "locality",
                                                with_stats=True)
    np.testing.assert_array_equal(t_out, j_out)
    _assert_stats(ts, js, SHARED, (engine, name))


def test_zone_state_helpers_round_trip():
    """The locality partitioner's one float of feedback snapshots and
    restores as the reference's does; a stateless partitioner snapshots as
    None and ignores a restore."""
    for mod in (jbu, tbu):
        loc = mod._resolve_partitioner("locality")
        assert mod._zone_state(loc) is None          # cold start
        loc.prev_locality = 0.75
        assert mod._zone_state(loc) == 0.75
        loc2 = mod._resolve_partitioner("locality")
        assert loc2 is not loc and loc2.prev_locality is None
        mod._restore_zone_state(loc2, mod._zone_state(loc))
        assert loc2.prev_locality == 0.75
        seq = mod._resolve_partitioner("sequential")
        assert mod._zone_state(seq) is None
        mod._restore_zone_state(seq, 0.5)            # attaches nothing
        assert mod._zone_state(seq) is None


@pytest.mark.parametrize("engine", ["bottom-up", "top-down"])
def test_locality_zone_state_journaled_and_restored(tmp_path, engine):
    """An interrupted locality run journals the zone state with its stage-1
    snapshot; it equals the reference's under the same interruption, and
    the resumed runs give the reference's phi and counters."""
    name, n, ce = CORPUS[3]                  # clustered: locality's regime
    budget = 16
    out = []
    for pkg, bu, td, fmod, extra in (
            ("j", jbu, jtd, jfaults, {}),
            ("t", tbu, ttd, faults, dict(device="cpu"))):
        d = str(tmp_path / pkg)
        if engine == "bottom-up":
            def fn(**kw):
                return bu.bottom_up_decompose(n, ce, budget,
                                              partitioner="locality", **kw)
            key = bu._run_key("bottom_up", n, ce, budget, "locality", 0,
                              devices=1)
        else:
            def fn(**kw):
                return td.top_down_decompose(n, ce, budget=budget,
                                             partitioner="locality", **kw)
            key = bu._run_key("top_down", n, ce, budget, "locality", 0,
                              t=None, faithful=False, devices=1)
        plan = fmod.FaultPlan([fmod.FaultRule(
            site=fmod.PARTITIONER, kind="error", where={"stage": 1},
            nth=3)])
        with _quiet(), fmod.active(plan), pytest.raises(fmod.InjectedFault):
            fn(checkpoint_dir=d, checkpoint_every=1, **extra)
        _, meta = bu.RoundJournal(d, key, every=1).load_latest()
        zs = meta.get("zone_state")
        assert meta["stage"] in ("lb", "sup")
        assert zs is not None and 0.0 <= float(zs) <= 1.0
        part_fn = bu._resolve_partitioner("locality")
        bu._restore_zone_state(part_fn, zs)
        assert part_fn.prev_locality == float(zs)
        with _quiet():
            res = fn(checkpoint_dir=d, resume=True, **extra)
        assert res.stats.resumed_round >= 0
        out.append((zs, meta["index"], res))
    (jzs, jidx, jres), (tzs, tidx, tres) = out
    assert (tzs, tidx) == (jzs, jidx)
    np.testing.assert_array_equal(tres.phi, jres.phi)
    _assert_stats(tres.stats, jres.stats,
                  SHARED + ("resumed_round", "checkpoints"), engine)
