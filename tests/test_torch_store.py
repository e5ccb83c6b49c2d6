"""The port's graph store (``repro_torch.core.store``) against ``repro``'s.

Mirrors ``tests/test_store.py`` on the port: round trips on both stores,
the chunk-wise filter and its aliasing, prefetch accounting, the host
budget, the ``IoAccount`` shared with checkpoint writes, the stale-file
sweep, both fault sites, torn-chunk detection, the graph spill, counter
absorption, the journal's charge, chunk streaming.  Where a case's outcome
is deterministic, the same operations run on the reference's store too and
the results and write counters must be equal.  (The insertion splice,
``put_inserted``, is held to the reference in ``test_torch_add_edges.py``.)
Every store is opened in a ``with`` block, so no prefetch thread outlives
its test.
"""

import glob
import os

import numpy as np
import pytest

from repro.core import faults as jfaults
from repro.core import graph as jgraph
from repro.core import store as jstore
from repro.core.bottom_up import OocStats as JOocStats
from repro.core.bottom_up import RoundJournal as JRoundJournal
from repro_torch.core import faults
from repro_torch.core import graph as tgraph
from repro_torch.core import store as tstore
from repro_torch.core.bottom_up import OocStats, RoundJournal
from repro_torch.core.store import (ChunkedDiskStore, InMemoryStore,
                                    IoAccount, StoreError, StoreStats)
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
WRITE_COUNTERS = ("chunk_writes", "bytes_spilled")


def _disk(tmp_path, mod=tstore, name="store", **kw):
    kw.setdefault("chunk_bytes", 256)   # many chunks even for tiny arrays
    return mod.ChunkedDiskStore(str(tmp_path / name), **kw)


def _writes(store):
    return {k: getattr(store.stats, k) for k in WRITE_COUNTERS}


def _both(tmp_path, scenario, **kw):
    """Run ``scenario(store, mod)`` on a disk store of each package;
    returns ``[(result, write counters)]``, reference first."""
    out = []
    for mod, name in ((jstore, "ref"), (tstore, "port")):
        with _disk(tmp_path, mod, name, **kw) as store:
            out.append((scenario(store, mod), _writes(store)))
    return out


# ---------------------------------------------------------------------------
# round trips
# ---------------------------------------------------------------------------

CASES = {
    "g1/edges": np.arange(1000, dtype=np.int64).reshape(-1, 2),
    "g1/deg": np.arange(37, dtype=np.int32),
    "g1/flags": np.array([True, False, True]),
    "g1/tris": np.arange(99, dtype=np.int64).reshape(-1, 3),
    "g1/empty": np.zeros((0, 2), dtype=np.int64),
}


@pytest.mark.parametrize("kind", ["memory", "disk"])
def test_put_get_roundtrip(tmp_path, kind):
    def scenario(store, mod):
        for key, arr in CASES.items():
            store.put(key, arr)
        return {key: store.get(key) for key in CASES}

    if kind == "memory":
        with InMemoryStore() as store:
            got = scenario(store, tstore)
        runs = [(got, None)]
    else:
        runs = _both(tmp_path, scenario)
        assert runs[0][1] == runs[1][1]
    for got, _ in runs:
        for key, arr in CASES.items():
            assert got[key].dtype == arr.dtype, key
            assert got[key].shape == arr.shape, key
            assert (got[key] == arr).all(), key


def test_disk_get_unknown_key_raises(tmp_path):
    with _disk(tmp_path) as store:
        with pytest.raises(StoreError, match="unknown"):
            store.get("g1/edges")


def test_put_overwrites_and_frees_old_chunks(tmp_path):
    with _disk(tmp_path) as store:
        store.put("g1/x", np.arange(500, dtype=np.int64))
        first = set(glob.glob(str(tmp_path / "store" / "*.bin")))
        store.put("g1/x", np.arange(5, dtype=np.int64))
        assert (store.get("g1/x") == np.arange(5)).all()
        assert not (first & set(glob.glob(str(tmp_path / "store"
                                              / "*.bin"))))


def test_inmemory_counters_stay_zero():
    with InMemoryStore() as store:
        arr = np.arange(100)
        store.put("g1/x", arr)
        assert store.get("g1/x") is store._data["g1/x"]    # no copy
        store.prefetch(["g1/x"])
        store.release("g1/x")
        assert store.stats.as_dict() == StoreStats().as_dict()
        assert StoreStats().as_dict() == jstore.StoreStats().as_dict()


# ---------------------------------------------------------------------------
# chunk-wise filter and aliasing (the remove_edges spill)
# ---------------------------------------------------------------------------

def test_put_filtered_rewrites_only_touched_chunks(tmp_path):
    src = np.arange(400, dtype=np.int64)
    keep = np.ones(400, dtype=bool)
    keep[150:160] = False       # rows dropped from the second chunk only

    def scenario(store, mod):
        store.put("g1/x", src)
        w0 = _writes(store)
        store.put_filtered("g2/x", "g1/x", keep, src[keep])
        delta = {k: v - w0[k] for k, v in _writes(store).items()}
        got = store.get("g2/x")
        store.release("g1/x")     # the filtered key outlives its source
        after = store.get("g2/x")
        store.release("g2/x")
        left = glob.glob(os.path.join(store.directory, "*.bin"))
        return delta, got, after, left

    runs = _both(tmp_path, scenario, chunk_bytes=800)   # 100 rows a chunk
    assert runs[0][1] == runs[1][1]
    for (delta, got, after, left), _ in runs:
        assert delta == {"chunk_writes": 1, "bytes_spilled": 90 * 8}
        assert (got == src[keep]).all() and (after == src[keep]).all()
        assert not left


def test_alias_costs_zero_write_io(tmp_path):
    with _disk(tmp_path) as store:
        rank = np.arange(1000, dtype=np.int64)
        store.put("g1/rank", rank)
        spilled = store.stats.bytes_spilled
        store.alias("g2/rank", "g1/rank", rank)
        assert store.stats.bytes_spilled == spilled
        store.release("g1/rank")
        assert (store.get("g2/rank") == rank).all()


def test_put_filtered_mask_mismatch_raises(tmp_path):
    with _disk(tmp_path) as store:
        src = np.arange(100, dtype=np.int64)
        store.put("g1/x", src)
        keep = np.ones(100, dtype=bool)
        keep[:10] = False
        with pytest.raises(StoreError, match="keeps"):
            store.put_filtered("g2/x", "g1/x", keep, src)   # wrong length


def test_put_filtered_without_source_falls_back_to_put(tmp_path):
    with _disk(tmp_path) as store:
        arr = np.arange(50, dtype=np.int64)
        store.put_filtered("g2/x", "g1/x", np.ones(99, bool), arr)
        assert (store.get("g2/x") == arr).all()


# ---------------------------------------------------------------------------
# budget and prefetch accounting
# ---------------------------------------------------------------------------

def test_prefetch_hits_on_streamed_get(tmp_path):
    with _disk(tmp_path, lookahead=4) as store:
        store.put("g1/x", np.arange(2000, dtype=np.int64))
        n_chunks = len(store._manifests["g1/x"].chunks)
        assert n_chunks > 4
        store.prefetch(["g1/x"])
        store.get("g1/x")
        s = store.stats
        assert s.prefetch_hits + s.prefetch_misses == n_chunks
        # the head was warmed and the window stays ahead: everything hits
        assert s.prefetch_misses == 0
        assert s.prefetch_hit_rate == 1.0


def test_cold_get_first_chunk_misses(tmp_path):
    with _disk(tmp_path) as store:
        store.put("g1/x", np.arange(2000, dtype=np.int64))
        store.get("g1/x")     # no prefetch hint: chunk 0 is read in place
        assert store.stats.prefetch_misses >= 1
        assert store.stats.prefetch_hits >= 1


def test_budget_caps_resident_bytes(tmp_path):
    budget = 600
    with _disk(tmp_path, host_memory_budget=budget, chunk_bytes=256,
               lookahead=8) as store:
        arr = np.arange(4000, dtype=np.int64)
        store.put("g1/x", arr)
        assert (store.get("g1/x") == arr).all()
        assert store.stats.peak_resident_bytes <= budget
        assert store.io_account.peak <= budget
        assert store.resident_bytes == 0    # read once: drained after get


def test_tight_budget_still_correct(tmp_path):
    # a budget below one chunk refuses every admission: every read is a
    # synchronous miss, and the data still comes back equal
    with _disk(tmp_path, host_memory_budget=64, chunk_bytes=256) as store:
        arr = np.arange(1024, dtype=np.int64)
        store.put("g1/x", arr)
        assert (store.get("g1/x") == arr).all()
        assert store.stats.prefetch_hits == 0
        assert store.stats.prefetch_misses > 0


def test_io_account_shared_with_checkpoint_hold(tmp_path):
    account = IoAccount(budget_bytes=512)
    with _disk(tmp_path, io_account=account, chunk_bytes=256) as store:
        store.put("g1/x", np.arange(500, dtype=np.int64))
        with account.hold(512, "checkpoint"):
            # a checkpoint in flight fills the budget: no chunk admitted
            store.prefetch(["g1/x"])
            assert store.resident_bytes == 0
            arr = store.get("g1/x")     # all synchronous misses
        assert (arr == np.arange(500)).all()
        assert store.stats.prefetch_hits == 0
        assert account.checkpoint_bytes_total == 512
        assert account.reserved == 0


def test_ctor_validation(tmp_path):
    for bad in ({"host_memory_budget": 0}, {"host_memory_budget": -1},
                {"chunk_bytes": 0}, {"lookahead": 0}):
        for mod in (jstore, tstore):
            with pytest.raises(ValueError):
                mod.ChunkedDiskStore(str(tmp_path / "s"), **bad)


def test_init_sweeps_stale_spill_files(tmp_path):
    d = tmp_path / "store"
    d.mkdir()
    (d / "dead-00000001.bin").write_bytes(b"x" * 64)
    (d / "dead-00000002.bin.tmp").write_bytes(b"y")
    (d / "keep.npz").write_bytes(b"z")      # not a spill file
    with ChunkedDiskStore(str(d)):
        pass
    assert sorted(os.listdir(d)) == ["keep.npz"]


# ---------------------------------------------------------------------------
# fault sites
# ---------------------------------------------------------------------------

def test_chunk_write_fault_injects(tmp_path):
    logs = []
    for mod, fmod, name in ((jstore, jfaults, "ref"),
                            (tstore, faults, "port")):
        plan = fmod.FaultPlan([fmod.FaultRule(
            site=fmod.CHUNK_WRITE, kind="error", nth=2)])
        with _disk(tmp_path, mod, name) as store, fmod.active(plan):
            with pytest.raises(fmod.InjectedFault):
                store.put("g1/x", np.arange(500, dtype=np.int64))
        assert len(plan.log) == 1
        ctx = dict(plan.log[0]["ctx"])
        assert os.path.dirname(ctx.pop("path")) == str(tmp_path / name)
        logs.append((plan.log[0]["site"], ctx))
    assert logs[0] == logs[1] == ("chunk-write", {"key": "g1/x", "chunk": 1})


def test_chunk_read_fault_injects_with_context(tmp_path):
    with _disk(tmp_path) as store:
        store.put("g1/x", np.arange(500, dtype=np.int64))
        plan = faults.FaultPlan([faults.FaultRule(
            site=faults.CHUNK_READ, kind="error",
            where={"key": "g1/x", "chunk": 0}, nth=1)])
        with faults.active(plan):
            with pytest.raises(faults.InjectedFault):
                store.get("g1/x")
        assert len(plan.log) == 1
        ctx = plan.log[0]["ctx"]
        assert (ctx["key"], ctx["chunk"]) == ("g1/x", 0)
        assert ctx["path"] == store._manifests["g1/x"].chunks[0].path


def test_torn_chunk_detected(tmp_path):
    with _disk(tmp_path) as store:
        store.put("g1/x", np.arange(500, dtype=np.int64))
        chunk = store._manifests["g1/x"].chunks[1]
        with open(chunk.path, "wb") as f:
            f.write(b"\0" * (chunk.nbytes - 8))     # truncated payload
        with pytest.raises(StoreError, match="torn") as err:
            store.get("g1/x")
    # a torn chunk is a fault of the data, not of the device: no retry
    assert not faults.is_retryable(err.value)


# ---------------------------------------------------------------------------
# the graph spill and counter absorption
# ---------------------------------------------------------------------------

def test_graph_spill_roundtrip_and_release(tmp_path):
    rng = np.random.default_rng(7)
    n = 40
    iu = np.triu_indices(n, 1)
    keep = rng.random(len(iu[0])) < 0.3
    ce = tgraph.canonical_edges(np.stack(iu, 1)[keep], n)
    ref2 = jgraph.build_graph(n, ce).remove_edges(np.arange(len(ce)) % 3 == 0)

    def scenario(store, mod):
        glib = jgraph if mod is jstore else tgraph
        g = glib.build_graph(n, ce, store=store)
        g.spill()
        g2 = g.remove_edges(np.arange(g.m) % 3 == 0)
        g2.spill()
        g.release()
        arrays = {nm: getattr(g2, nm) for nm in tgraph.Graph._ARRAYS}
        g2.release()
        return arrays, glob.glob(os.path.join(store.directory, "*.bin"))

    runs = _both(tmp_path, scenario)
    assert runs[0][1] == runs[1][1]     # same chunks written, same bytes
    for (arrays, left), _ in runs:
        for name, arr in arrays.items():
            want = getattr(ref2, name)
            assert arr.dtype == want.dtype and (arr == want).all(), name
        assert not left


@pytest.mark.parametrize("name,n,edges", CORPUS, ids=IDS)
def test_spilled_graph_arrays_equal_reference(tmp_path, name, n, edges):
    """The port's graph arrays, spilled and read back, equal the
    reference's ``build_graph`` arrays in dtype and value, and the spill
    writes what the reference's writes."""
    ref = jgraph.build_graph(n, edges)

    def scenario(store, mod):
        glib = jgraph if mod is jstore else tgraph
        g = glib.build_graph(n, edges, store=store)
        g.spill()
        assert not g._arrays
        g.prefetch()
        out = {nm: getattr(g, nm) for nm in tgraph.Graph._ARRAYS}
        g.unload()
        assert not g._arrays
        return out, (g.n, g.m, g.max_out_deg)

    runs = _both(tmp_path, scenario)
    assert runs[0][1] == runs[1][1], name
    for (arrays, scalars), _ in runs:
        assert scalars == (ref.n, ref.m, ref.max_out_deg)
        for nm, arr in arrays.items():
            want = getattr(ref, nm)
            assert arr.dtype == want.dtype, (name, nm)
            np.testing.assert_array_equal(arr, want, err_msg=f"{name} {nm}")


def test_dropped_array_without_store_raises():
    g = tgraph.build_graph(3, np.array([[0, 1], [1, 2]]))
    g.spill()               # no store: a no-op
    assert (g.edges == [[0, 1], [1, 2]]).all()
    g.release()
    with pytest.raises(RuntimeError, match="without a store"):
        g.edges


def test_absorb_into_is_delta_based(tmp_path):
    with _disk(tmp_path) as store:
        store.put("g1/x", np.arange(500, dtype=np.int64))
        stats = OocStats()
        store.absorb_into(stats)
        mid = stats.chunk_writes
        assert mid == store.stats.chunk_writes > 0
        store.absorb_into(stats)                 # no new I/O: no change
        assert stats.chunk_writes == mid
        store.get("g1/x")
        store.absorb_into(stats)
        assert stats.chunk_reads == store.stats.chunk_reads > 0
    for field in tstore._ABSORB_KEYS:
        assert hasattr(stats, field) and hasattr(JOocStats(), field)
    assert tstore._ABSORB_KEYS == jstore._ABSORB_KEYS


def test_round_journal_charges_store_account(tmp_path):
    out = []
    for mod, journal_cls, stats_cls, name in (
            (jstore, JRoundJournal, JOocStats, "ref"),
            (tstore, RoundJournal, OocStats, "port")):
        with _disk(tmp_path, mod, name) as store:
            store.put("g1/x", np.arange(64, dtype=np.int64))
            journal = journal_cls(str(tmp_path / name / "ckpt"), "rk",
                                  every=1, store=store)
            stats = stats_cls()
            assert journal.record("s1", 0,
                                  {"phi": np.arange(8, dtype=np.int64)},
                                  stats)
            account = store.io_account
            assert account.reserved == 0         # released after the save
            # the journal absorbed the store counters into the snapshot
            assert stats.chunk_writes == store.stats.chunk_writes > 0
            out.append((account.checkpoint_bytes_total, stats.chunk_writes,
                        stats.bytes_spilled))
    assert out[0] == out[1] and out[1][0] > 0


# ---------------------------------------------------------------------------
# chunk streaming (the spilled triangle list)
# ---------------------------------------------------------------------------

def test_get_chunks_bounds_peak_to_one_chunk(tmp_path):
    with _disk(tmp_path) as store:        # 256 B chunks = 32 int64 rows
        arr = np.arange(2000, dtype=np.int64)
        store.put("g1/x", arr)
        parts = []
        for part in store.get_chunks("g1/x"):
            assert len(part) <= 32        # never the whole key
            assert not part.flags.writeable
            parts.append(np.asarray(part))
        assert len(parts) > 4
        assert (np.concatenate(parts) == arr).all()
        with pytest.raises(StoreError, match="unknown"):
            list(store.get_chunks("nope/x"))


def test_stream_put_flushes_incrementally(tmp_path):
    rows = np.arange(300, dtype=np.int64).reshape(-1, 3)

    def scenario(store, mod):
        d = store.directory
        files0 = len(glob.glob(os.path.join(d, "*.bin")))
        with store.stream_put("g1/tris", np.int64, (3,)) as w:
            for lo in range(0, 100, 7):   # odd-sized appends
                w.append(rows[lo:lo + 7])
                assert w.rows == min(lo + 7, 100)
            # full chunks are on disk before close
            assert len(glob.glob(os.path.join(d, "*.bin"))) > files0
            with pytest.raises(mod.StoreError, match="unknown"):
                store.get("g1/tris")      # registered only at close
        return store.get("g1/tris")

    runs = _both(tmp_path, scenario)      # 256 B chunks = 10 rows of 3
    assert runs[0][1] == runs[1][1]
    for got, _ in runs:
        assert (got == rows).all()


def test_stream_put_same_key_keeps_old_until_close(tmp_path):
    with _disk(tmp_path) as store:
        old = np.arange(60, dtype=np.int64).reshape(-1, 3)
        store.put("g1/tris", old)
        w = store.stream_put("g1/tris", np.int64, (3,))
        w.append(old[:5] * 2)
        assert (store.get("g1/tris") == old).all()    # still the old rows
        w.close()
        assert (store.get("g1/tris") == old[:5] * 2).all()


def test_stream_put_empty_registers_empty_key(tmp_path):
    with _disk(tmp_path) as store:
        with store.stream_put("g1/tris", np.int64, (3,)) as w:
            assert w.rows == 0
        got = store.get("g1/tris")
        assert got.shape == (0, 3) and got.dtype == np.int64


@pytest.mark.parametrize("kind", ["memory", "disk"])
def test_triangle_spill_helpers_equal_reference(tmp_path, kind):
    """``spill_triangles`` / ``load_triangles`` / ``iter_triangle_chunks``
    / ``stream_spill_triangles`` keep int64 (T, 3) rows, and on the disk
    store write what the reference's helpers write."""
    from repro.core import support as jsup
    from repro_torch.core import support as tsup

    tris = np.random.default_rng(3).integers(0, 500, (123, 3)).astype(
        np.int32)

    def scenario(store, mod):
        sup = jsup if mod is jstore else tsup
        sup.spill_triangles(store, "g1/tris", tris)
        whole = sup.load_triangles(store, "g1/tris")
        parts = list(sup.iter_triangle_chunks(store, "g1/tris"))
        with sup.stream_spill_triangles(store, "g2/tris") as w:
            for p in parts:
                w.append(p[::2])
        return whole, parts, sup.load_triangles(store, "g2/tris")

    if kind == "memory":
        with InMemoryStore() as store:
            runs = [(scenario(store, tstore), None)]
    else:
        runs = _both(tmp_path, scenario)
        assert runs[0][1] == runs[1][1]
    for (whole, parts, sub), _ in runs:
        assert whole.dtype == np.int64 and (whole == tris).all()
        assert all(p.dtype == np.int64 and p.shape[1] == 3 for p in parts)
        assert (np.concatenate(parts) == tris).all()
        assert (sub == np.concatenate([p[::2] for p in parts])).all()
