"""``Graph.add_edges`` and the stores' ``put_inserted`` in the port, against
``repro``.

``add_edges`` splices new edges into the canonical order and into the CSR
rows with the ranks reused; every array must equal the reference's, array
for array, including when the pairs hold duplicates, self loops and edges
already present (those are dropped; with nothing left the graph itself is
returned).  ``put_inserted`` must give the reference's arrays and write
counters, alias the same chunks, fall back to a plain put on a mismatch,
and keep the successor's aliased chunk files alive when the predecessor is
released.  Every store is opened in a ``with`` block.
"""

import glob

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import store as jstore
from repro_torch.core import graph as tgraph
from repro_torch.core import store as tstore
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
ARRAYS = ("edges", "src", "dst", "deg", "rank", "indptr", "nbrs", "nbr_eid")
WRITE_COUNTERS = ("chunk_writes", "bytes_spilled")


def _absent(rng, n, ce, k):
    present = {tuple(e) for e in np.asarray(ce).tolist()}
    out = []
    while len(out) < k:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        a, b = min(u, v), max(u, v)
        if a != b and (a, b) not in present:
            present.add((a, b))
            out.append((v, u))          # not canonical: add_edges sorts
    return np.asarray(out, np.int64).reshape(-1, 2)


def _pairs(kind, rng, n, ce):
    new = _absent(rng, n, ce, 4)
    if kind == "absent":
        return new
    if kind == "messy":      # duplicates, a self loop, a present edge
        extra = [new[:2], new[:1, ::-1], [[3, 3]]]
        if len(ce):
            extra.append(ce[:1])
        return np.concatenate([new] + [np.asarray(x, np.int64)
                                       for x in extra])
    if kind == "present":
        return np.asarray(ce[:3], np.int64).reshape(-1, 2)
    return np.zeros((0, 2), np.int64)   # "empty"


def _assert_graphs_equal(t, j, where):
    assert (t.n, t.m, t.max_out_deg) == (j.n, j.m, j.max_out_deg), where
    for name in ARRAYS:
        a, b = getattr(t, name), getattr(j, name)
        np.testing.assert_array_equal(a, b, err_msg=f"{where} {name}")
        assert a.dtype == b.dtype, (where, name, a.dtype, b.dtype)


@pytest.mark.parametrize("kind", ["absent", "messy", "present", "empty"])
@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_add_edges_equals_reference(name, n, ce, kind):
    pairs = _pairs(kind, np.random.default_rng(41), n, ce)
    jg, tg = jgraph.build_graph(n, ce), tgraph.build_graph(n, ce)
    j1, t1 = jg.add_edges(pairs), tg.add_edges(pairs)
    assert (t1 is tg) == (j1 is jg), (name, kind)
    if kind in ("present", "empty"):
        assert t1 is tg
    _assert_graphs_equal(t1, j1, (name, kind))
    # the spliced graph holds exactly the union, in canonical order
    want = tgraph.canonical_edges(np.concatenate([ce, pairs]), n)
    np.testing.assert_array_equal(t1.edges, want)


@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_add_after_remove_reuses_ranks(name, n, ce):
    """A remove-then-insert chain (what maintenance does) keeps the first
    graph's ranks and equals the reference at every step."""
    rng = np.random.default_rng(43)
    rm = np.zeros(len(ce), bool)
    rm[rng.choice(len(ce), min(3, len(ce)), replace=False)] = True
    jg, tg = jgraph.build_graph(n, ce), tgraph.build_graph(n, ce)
    j1, t1 = jg.remove_edges(rm), tg.remove_edges(rm)
    pairs = np.concatenate([ce[rm], _absent(rng, n, ce, 2)])
    j2, t2 = j1.add_edges(pairs), t1.add_edges(pairs)
    _assert_graphs_equal(t2, j2, name)
    np.testing.assert_array_equal(t2.rank, tg.rank)


def _disk(tmp_path, mod, name, chunk_bytes=800):
    return mod.ChunkedDiskStore(str(tmp_path / name), chunk_bytes=chunk_bytes)


def _writes(store):
    return {k: getattr(store.stats, k) for k in WRITE_COUNTERS}


# (source rows, splice positions in the new array): 100 int64 rows a chunk
SPLICES = {
    "middle": (400, [150, 151, 152]),
    "front": (400, [0, 1]),
    "back": (400, [400, 401]),
    "boundaries": (400, [100, 201, 302]),
    "scattered": (400, [5, 120, 250, 399, 403]),
    "run-past-a-chunk": (250, list(range(90, 260))),
}


@pytest.mark.parametrize("case", list(SPLICES))
def test_put_inserted_equals_reference(tmp_path, case):
    rows, at = SPLICES[case]
    src = np.arange(rows, dtype=np.int64)
    is_new = np.zeros(rows + len(at), dtype=bool)
    is_new[at] = True
    arr = np.empty(rows + len(at), np.int64)
    arr[~is_new] = src
    arr[is_new] = 10_000 + np.arange(len(at))
    out = []
    for mod, name in ((jstore, "ref"), (tstore, "port")):
        with _disk(tmp_path, mod, name) as store:
            store.put("g1/x", src)
            w0 = _writes(store)
            store.put_inserted("g2/x", "g1/x", is_new, arr)
            got = store.get("g2/x")
            writes = {k: v - w0[k] for k, v in _writes(store).items()}
            aliased = sum(c.path in {s.path for s in
                                     store._manifests["g1/x"].chunks}
                          for c in store._manifests["g2/x"].chunks)
            # the aliased files survive the predecessor's release
            store.release("g1/x")
            np.testing.assert_array_equal(store.get("g2/x"), arr)
            store.release("g2/x")
            left = glob.glob(str(tmp_path / name / "*.bin"))
        np.testing.assert_array_equal(got, arr)
        assert not left, (case, name)
        out.append((writes, aliased))
    assert out[1] == out[0], (case, out)
    if case == "middle":        # chunks 0, 2 and 3 are aliased
        assert out[1] == ({"chunk_writes": 2, "bytes_spilled": 824}, 3)


@pytest.mark.parametrize("why", ["rows", "source", "dtype", "shape"])
def test_put_inserted_mismatch_falls_back_to_put(tmp_path, why):
    src = np.arange(100, dtype=np.int64)
    arr = np.arange(50, dtype=np.int64)
    is_new = np.zeros(50, dtype=bool)
    src_key = "g1/x"
    if why == "rows":           # is_new keeps another row count
        is_new = np.ones(50, dtype=bool)
    elif why == "source":       # no such source key
        src_key = "nope/x"
    elif why == "dtype":
        src, arr = src[:50].astype(np.int32), arr
    else:
        src = np.arange(100, dtype=np.int64).reshape(50, 2)
    out = []
    for mod, name in ((jstore, "ref"), (tstore, "port")):
        with _disk(tmp_path, mod, name) as store:
            store.put("g1/x", src)
            w0 = _writes(store)
            store.put_inserted("g2/x", src_key, is_new, arr)
            np.testing.assert_array_equal(store.get("g2/x"), arr)
            man = store._manifests["g2/x"]
            own = all(store._file_refs[c.path] == 1 for c in man.chunks)
            out.append(({k: v - w0[k] for k, v in _writes(store).items()},
                        own))
    assert out[1] == out[0] and out[1][1], (why, out)


def test_base_store_put_inserted_is_a_put():
    with tstore.InMemoryStore() as store:
        src = np.arange(10, dtype=np.int64)
        store.put("g1/x", src)
        arr = np.insert(src, 4, 99)
        is_new = np.zeros(11, dtype=bool)
        is_new[4] = True
        store.put_inserted("g2/x", "g1/x", is_new, arr)
        np.testing.assert_array_equal(store.get("g2/x"), arr)
        assert all(v == 0 for v in _writes(store).values())


@pytest.mark.parametrize("name,n,ce", CORPUS[:4], ids=IDS[:4])
def test_graph_spill_insert_plan(tmp_path, name, n, ce):
    """A spilled graph's ``add_edges`` successor spills through the insert
    plan: the same chunk writes as the reference, its arrays read back
    equal, and they stay readable after the predecessor's release."""
    pairs = _absent(np.random.default_rng(47), n, ce, 3)
    out = []
    for mod, gmod, tag in ((jstore, jgraph, "ref"), (tstore, tgraph, "port")):
        with _disk(tmp_path, mod, tag, chunk_bytes=64) as store:
            g = gmod.build_graph(n, ce, store=store)
            g.spill()
            w0 = _writes(store)
            g1 = g.add_edges(pairs)
            g1.spill()
            writes = {k: v - w0[k] for k, v in _writes(store).items()}
            g.release()
            arrays = {a: getattr(g1, a).copy() for a in ARRAYS}
            g1.unload()
            again = {a: getattr(g1, a) for a in ARRAYS}
            g1.release()
            left = glob.glob(str(tmp_path / tag / "*.bin"))
        assert not left, (name, tag)
        for a in ARRAYS:
            np.testing.assert_array_equal(again[a], arrays[a])
        out.append((writes, arrays))
    (jw, ja), (tw, ta) = out
    assert tw == jw, (name, tw, jw)
    for a in ARRAYS:
        np.testing.assert_array_equal(ta[a], ja[a], err_msg=f"{name} {a}")
