"""The port's out-of-core drivers over a graph store, against ``repro``.

Mirrors ``test_conformance_store_matrix`` and
``test_conformance_host_memory_budget_knob`` (``tests/test_conformance.py``),
``test_sigkill_mid_chunk_spill_and_resume`` (``tests/test_resume.py``) and
``test_disk_store_budget_sweep`` (``tests/test_ooc_property.py``) on
``repro_torch``: over the conformance corpus, bottom-up and budgeted
top-down through an ``InMemoryStore`` and a ``ChunkedDiskStore``, with the
sequential and the locality partitioner, must give the reference's phi,
the reference's shared ``OocStats`` counters and, on disk, the reference's
write counters for the same chunk size.  The prefetch hit and miss counts
depend on thread timing, so only their sum and the rate's bounds are
checked.  The port runs on the CPU; every store is closed by a ``with``.
"""

import contextlib
import os
import subprocess
import sys
import tempfile
import warnings
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import bottom_up as jbu
from repro.core import peel as jpeel
from repro.core import store as jstore
from repro.core.partition import PartitionBudgetWarning
from repro.core.serial import alg2_truss
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import bottom_up as tbu
from repro_torch.core import faults
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from repro_torch.core import peel as tpeel
from repro_torch.core import store as tstore
from repro_torch.core import top_down as ttd
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
REPO = Path(__file__).resolve().parents[1]
SHARED = ("rounds", "scans", "batches", "parts", "tri_total",
          "tri_assigned", "tri_est", "tri_rescans_avoided")
# I/O counters that do not depend on the prefetch thread's timing
DETERMINISTIC_IO = ("chunk_writes", "bytes_spilled", "tri_spill_rows",
                    "tri_reload_peak_rows")
# the store's own I/O counters (the triangle-row counters also move on an
# InMemoryStore, which holds the spilled list as it is)
IO = tstore._ABSORB_KEYS


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PartitionBudgetWarning)
        warnings.simplefilter("ignore", tpart.PartitionBudgetWarning)
        yield


def _store(mod, kind, path):
    if kind == "memory":
        return mod.InMemoryStore()
    return mod.ChunkedDiskStore(str(path), chunk_bytes=1 << 10)


def _assert_stats(t, j, fields, where):
    for f in fields:
        assert getattr(t, f) == getattr(j, f), (where, f, getattr(t, f),
                                                getattr(j, f))


@pytest.mark.parametrize("engine", ("bottom-up", "top-down"))
@pytest.mark.parametrize("store_kind", ("memory", "disk"))
@pytest.mark.parametrize("partitioner", ("sequential", "locality"))
def test_store_matrix(tmp_path, engine, store_kind, partitioner):
    for i, (name, n, ce) in enumerate(CORPUS):
        tag = (engine, store_kind, partitioner, name)
        runs = []
        for mod, peel, extra in ((jstore, jpeel, {}),
                                 (tstore, tpeel, dict(device="cpu"))):
            path = tmp_path / f"{mod.__name__}-{i}"
            with _store(mod, store_kind, path) as store, _quiet():
                runs.append(peel.truss_decompose(
                    n, ce, engine=engine, memory_budget=max(48, len(ce)),
                    partitioner=partitioner, store=store, with_stats=True,
                    **extra))
        (jphi, js), (tphi, ts) = runs
        np.testing.assert_array_equal(tphi, jphi, err_msg=str(tag))
        _assert_stats(ts, js, SHARED + DETERMINISTIC_IO, tag)
        if store_kind == "disk":
            assert ts.chunk_writes > 0 and ts.bytes_spilled > 0, tag
            assert ts.chunk_reads > 0, tag
            assert ts.prefetch_hits + ts.prefetch_misses > 0, tag
            assert 0.0 <= ts.prefetch_hit_rate <= 1.0, tag
        else:
            assert all(getattr(ts, f) == 0 for f in IO), tag


@pytest.mark.parametrize("store_kind", ("memory", "disk"))
@pytest.mark.parametrize("partitioner", ("sequential", "locality"))
def test_lower_bounding_store_equal(tmp_path, store_kind, partitioner):
    """``lower_bounding(store=)``: lb, phi and ``in_gnew`` equal the
    reference's, and the store's counters reach the stats."""
    for i, (name, n, ce) in enumerate(CORPUS):
        budget = max(8, len(ce) // 4)
        runs = []
        for mod, bu, extra in ((jstore, jbu, {}),
                               (tstore, tbu, dict(device="cpu"))):
            with _store(mod, store_kind, tmp_path / f"{bu.__name__}-{i}") \
                    as store, _quiet():
                runs.append(bu.lower_bounding(n, ce, budget, partitioner,
                                              store=store, **extra))
        j, t = runs
        for f in ("lb", "phi", "in_gnew"):
            np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                          err_msg=f"{name} {f}")
        _assert_stats(t.stats, j.stats,
                      SHARED + (DETERMINISTIC_IO if store_kind == "disk"
                                else ()), name)
        if store_kind == "disk" and len(ce):
            assert t.stats.chunk_writes > 0


@pytest.mark.parametrize("partitioner", ("sequential", "locality"))
def test_partitioned_support_store_equal(tmp_path, partitioner):
    for i, (name, n, ce) in enumerate(CORPUS):
        budget = max(8, len(ce) // 4)
        runs = []
        for mod, bu in ((jstore, jbu), (tstore, tbu)):
            with _store(mod, "disk", tmp_path / f"{bu.__name__}-{i}") \
                    as store, _quiet():
                runs.append(bu.partitioned_support(
                    n, ce, budget, partitioner, with_stats=True,
                    store=store))
        (jsup, js), (tsup, ts) = runs
        np.testing.assert_array_equal(tsup, jsup, err_msg=name)
        _assert_stats(ts, js, SHARED + DETERMINISTIC_IO, name)


@pytest.mark.parametrize("engine", ("bottom-up", "top-down"))
def test_host_memory_budget_knob(tmp_path, monkeypatch, engine):
    """``host_memory_budget=`` alone builds a ``ChunkedDiskStore`` in a
    fresh temporary directory: phi equals the reference's, chunks were
    written, and the directory is gone when the call returns (the
    reference leaves its ``truss-store-*`` directory behind)."""
    tmp = tmp_path / "tmp"
    tmp.mkdir()
    monkeypatch.setattr(tempfile, "tempdir", str(tmp))
    for name, n, ce in CORPUS:
        with _quiet():
            want = jpeel.truss_decompose(n, ce, engine=engine,
                                         memory_budget=max(48, len(ce)))
            phi, stats = tpeel.truss_decompose(
                n, ce, engine=engine, memory_budget=max(48, len(ce)),
                host_memory_budget=1 << 16, with_stats=True, device="cpu")
        np.testing.assert_array_equal(phi, want, err_msg=name)
        assert stats.chunk_writes > 0, name
        assert not [p for p in os.listdir(tmp)
                    if p.startswith("truss-store-")], name


def test_store_arguments_validated(tmp_path):
    e = np.array([[0, 1], [1, 2], [0, 2]])
    with pytest.raises(ValueError, match="host_memory_budget"):
        tpeel.truss_decompose(3, e, engine="bottom-up",
                              host_memory_budget=0, device="cpu")
    with tstore.InMemoryStore() as store:
        with pytest.raises(ValueError, match="budget"):
            ttd.top_down_decompose(3, e, store=store, device="cpu")
    with tstore.InMemoryStore() as store:
        with pytest.raises(NotImplementedError, match="ROADMAP A12"):
            tbu.partitioned_support(3, e, 64, engine="perpart", store=store)


def test_store_error_propagates_without_retry(tmp_path):
    """A chunk torn mid-run (``truncate`` at the ``chunk-read`` site) raises
    ``StoreError`` out of the driver in both packages; it is not a
    retryable failure."""
    name, n, ce = CORPUS[0]
    from repro.core import faults as jfaults

    for mod, fmod, bu, extra in (
            (jstore, jfaults, jbu, {}),
            (tstore, faults, tbu, dict(device="cpu"))):
        plan = fmod.FaultPlan([fmod.FaultRule(
            site=fmod.CHUNK_READ, kind="truncate", nth=3)])
        with mod.ChunkedDiskStore(str(tmp_path / bu.__name__),
                                  chunk_bytes=1 << 10) as store, \
                _quiet(), fmod.active(plan):
            with pytest.raises(mod.StoreError, match="torn") as err:
                bu.bottom_up_decompose(n, ce, 64, store=store, **extra)
        assert len(plan.log) == 1
        assert not fmod.is_retryable(err.value)


_SPILL_KILL_CHILD = r"""
import sys
sys.modules["jax"] = None          # the child imports only repro_torch
sys.modules["repro"] = None
import os
import warnings
import numpy as np
from repro_torch.core import faults
from repro_torch.core.bottom_up import bottom_up_decompose
from repro_torch.core.store import ChunkedDiskStore

ckpt_dir, store_dir, graph, nth = sys.argv[1:5]
nth = int(nth)
edges = np.load(graph)
n = int(edges.max()) + 1
if nth >= 0:
    faults.install(faults.FaultPlan([faults.FaultRule(
        site=faults.CHUNK_WRITE, kind="kill", nth=nth)]))
warnings.simplefilter("ignore")
with ChunkedDiskStore(store_dir, chunk_bytes=1 << 10) as store:
    swept = sorted(os.listdir(store_dir))
    res = bottom_up_decompose(n, edges, budget=64, checkpoint_dir=ckpt_dir,
                              checkpoint_every=1, resume=True, store=store,
                              device="cpu")
np.save(ckpt_dir + "/phi.npy", res.phi)
print("swept", len(swept), "resumed_round", res.stats.resumed_round)
"""


def test_sigkill_mid_chunk_spill_and_resume(tmp_path):
    """SIGKILL inside a chunk spill (a ``kill`` rule at ``chunk-write``):
    the 25th of the run's 40 chunk writes, as in the reference's test, is
    in the middle of a graph's spill after the first journaled round.  The
    journal survives the torn store directory, the restarted store sweeps
    the dead process's files, and the resumed phi equals the
    reference's."""
    name, n, ce = CORPUS[0]
    with tstore.ChunkedDiskStore(str(tmp_path / "probe"),
                                 chunk_bytes=1 << 10) as store, _quiet():
        full = tbu.bottom_up_decompose(n, ce, 64, store=store, device="cpu")
    nth = 25
    assert full.stats.chunk_writes == 40
    d, sd = str(tmp_path / "ckpt"), str(tmp_path / "store")
    os.makedirs(d)
    graph = str(tmp_path / "edges.npy")
    np.save(graph, ce)
    assert int(ce.max()) + 1 == n
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    kill = subprocess.run(
        [sys.executable, "-c", _SPILL_KILL_CHILD, d, sd, graph, str(nth)],
        env=env, capture_output=True, text=True, timeout=300)
    assert kill.returncode == -9, (kill.returncode, kill.stderr[-2000:])
    assert not os.path.exists(d + "/phi.npy")       # it died mid-run
    assert ckpt.latest_step(d) is not None
    leftovers = {f for f in os.listdir(sd) if f.endswith(".bin")}
    assert leftovers                   # the dead run's spill files
    resume = subprocess.run(
        [sys.executable, "-c", _SPILL_KILL_CHILD, d, sd, graph, "-1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert resume.returncode == 0, resume.stderr[-2000:]
    words = resume.stdout.split()
    assert words[:2] == ["swept", "0"]         # nothing survived the sweep
    assert int(words[-1]) >= 0
    assert not leftovers & set(os.listdir(sd))
    with _quiet():
        want = jbu.bottom_up_decompose(n, ce, 64).phi
    np.testing.assert_array_equal(np.load(d + "/phi.npy"), want)
    np.testing.assert_array_equal(full.phi, want)


@st.composite
def graphs(draw, max_n=26):
    n = draw(st.integers(4, max_n))
    density = draw(st.floats(0.1, 0.6))
    seed = draw(st.integers(0, 2**31 - 1))
    rng = np.random.default_rng(seed)
    iu = np.triu_indices(n, 1)
    keep = rng.random(len(iu[0])) < density
    return n, np.stack(iu, 1)[keep]


@settings(max_examples=10, deadline=None)
@given(graphs(), st.sampled_from([0.15, 0.4]),
       st.sampled_from([1 << 9, 1 << 12, 1 << 16, None]),
       st.sampled_from([1 << 8, 1 << 11]))
def test_disk_store_budget_sweep(g, budget_frac, host_budget, chunk_bytes):
    """For any host budget (down to refusing every admission) and chunk
    size, the port's disk-backed bottom-up gives the oracle's phi, writes
    what the reference writes, and the store never holds more than the
    budget."""
    n, edges = g
    ce = tgraph.canonical_edges(edges, n)
    if len(ce) < 3:
        return
    oracle = alg2_truss(n, ce)
    budget = max(4, int(len(ce) * budget_frac))
    out = []
    for mod, bu, extra in ((jstore, jbu, {}),
                           (tstore, tbu, dict(device="cpu"))):
        with tempfile.TemporaryDirectory() as d, _quiet():
            with mod.ChunkedDiskStore(d, host_memory_budget=host_budget,
                                      chunk_bytes=chunk_bytes) as store:
                res = bu.bottom_up_decompose(n, ce, budget, store=store,
                                             **extra)
                peak = store.stats.peak_resident_bytes
        out.append(res.stats)
        np.testing.assert_array_equal(res.phi, oracle)
        if host_budget is not None:
            assert peak <= host_budget
    js, ts = out
    _assert_stats(ts, js, SHARED + DETERMINISTIC_IO, (n, budget))
    assert ts.chunk_writes > 0 and ts.chunk_reads > 0
    assert ts.bytes_spilled > 0
    assert ts.prefetch_hits + ts.prefetch_misses > 0
    assert 0.0 <= ts.prefetch_hit_rate <= 1.0
