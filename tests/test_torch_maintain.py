"""Incremental truss maintenance in the port (``repro_torch.core.maintain``)
against ``repro.core.maintain`` and the serial oracle.

On the conformance corpus, insert-only, delete-only and mixed batches must
give the reference's maintained graph and phi, which must equal
``alg2_truss`` on the final edge list, and the reference's maintenance
counters (``edits_applied``, ``rounds``, ``maintain_levels``,
``affected_edges``).  Also: ``EditBatch`` ordering, no-op edits, the input
errors, ``truss_decompose(edits=, phi0=)``, the journal's run key, a run
stopped by an injected error or a SIGKILL and resumed, a foreign journal
refused, and edits on a spilled ``ChunkedDiskStore`` with the reference's
write counters.  Every port call runs on the CPU (exact equality
throughout: phi and the counters are integers).
"""

import json
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro.core import bottom_up as jbu
from repro.core import faults as jfaults
from repro.core import maintain as jm
from repro.core import store as jstore
from repro.core.serial import alg2_truss
from repro_torch.core import bottom_up as tbu
from repro_torch.core import faults
from repro_torch.core import graph as tgraph
from repro_torch.core import maintain as tm
from repro_torch.core import peel as tpeel
from repro_torch.core import store as tstore
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
PHI0 = {name: alg2_truss(n, ce) for name, n, ce in CORPUS}
REPO = Path(__file__).resolve().parents[1]
COUNTERS = ("edits_applied", "rounds", "maintain_levels", "affected_edges")


def _existing(rng, ce, k):
    ids = rng.choice(len(ce), size=min(k, len(ce)), replace=False)
    return [tuple(int(x) for x in ce[i]) for i in ids]


def _absent(rng, n, ce, k):
    present = {tuple(e) for e in np.asarray(ce).tolist()}
    out = []
    while len(out) < k:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        a, b = min(u, v), max(u, v)
        if a != b and (a, b) not in present:
            present.add((a, b))
            out.append((a, b))
    return out


def _steps(kind, n, ce, seed):
    rng = np.random.default_rng(seed)
    dels = [("delete", u, v) for u, v in _existing(rng, ce, 3)]
    ins = [("insert", u, v) for u, v in _absent(rng, n, ce, 3)]
    if kind == "insert":
        return ins
    if kind == "delete":
        return dels
    return [s for pair in zip(dels, ins) for s in pair] + ins[len(dels):]


def _final_edges(n, ce, steps):
    s = {tuple(e) for e in np.asarray(ce).tolist()}
    for op, u, v in steps:
        a, b = min(int(u), int(v)), max(int(u), int(v))
        if op == "delete":
            s.discard((a, b))
        elif a != b:
            s.add((a, b))
    return tgraph.canonical_edges(
        np.asarray(sorted(s), np.int64).reshape(-1, 2), n)


def _check(n, ce, phi0, steps, jkw=None, **tkw):
    """Maintain with both packages; the port must equal the reference and
    the oracle on the final edge list.  Returns the port's result."""
    j = jm.truss_maintain((n, ce), phi0, steps, **(jkw or {}))
    t = tm.truss_maintain((n, ce), phi0, steps, device="cpu", **tkw)
    want = _final_edges(n, ce, steps)
    np.testing.assert_array_equal(t.graph.edges, want)
    np.testing.assert_array_equal(j.graph.edges, want)
    np.testing.assert_array_equal(t.phi, j.phi)
    np.testing.assert_array_equal(t.phi, alg2_truss(n, want))
    assert t.phi.dtype == np.int64
    for f in COUNTERS:
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    return t


@pytest.mark.parametrize("kind", ["insert", "delete", "mixed"])
@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_maintain_equals_reference_and_oracle(name, n, ce, kind):
    steps = _steps(kind, n, ce, seed=11)
    res = _check(n, ce, PHI0[name], steps)
    assert res.stats.edits_applied == len(steps)


@pytest.mark.parametrize("direction", ["raise", "lower"])
def test_clique_edit_moves_trussness(direction):
    """Completing K6 lifts every edge to 6; breaking it lowers the rest."""
    n = 6
    full = tgraph.canonical_edges(np.stack(np.triu_indices(n, 1), 1), n)
    u, v = (int(x) for x in full[0])
    if direction == "raise":
        ce, steps = full[1:], [("insert", u, v)]
    else:
        ce, steps = full, [("delete", u, v)]
    phi0 = alg2_truss(n, ce)
    res = _check(n, ce, phi0, steps)
    if direction == "raise":
        assert (res.phi == 6).all()
    else:
        assert res.phi.max() < phi0.max()


def test_edit_batch_deletes_first():
    name, n, ce = CORPUS[0]
    rng = np.random.default_rng(19)
    dels = np.asarray(_existing(rng, ce, 2), np.int64)
    ins = np.asarray(_absent(rng, n, ce, 2), np.int64)
    batch = tm.EditBatch(inserts=ins, deletes=dels)
    steps = ([("delete", int(u), int(v)) for u, v in dels]
             + [("insert", int(u), int(v)) for u, v in ins])
    assert tm._normalize_edits(batch) == steps
    assert tm._normalize_edits(batch) == jm._normalize_edits(
        jm.EditBatch(inserts=ins, deletes=dels))
    res = tm.truss_maintain((n, ce), PHI0[name], batch, device="cpu")
    ref = _check(n, ce, PHI0[name], steps)
    np.testing.assert_array_equal(res.phi, ref.phi)
    np.testing.assert_array_equal(res.graph.edges, ref.graph.edges)
    assert res.stats.edits_applied == 4


def test_noop_edits_skipped():
    """Deleting an absent edge, inserting a present one or a self loop:
    phi and the graph stay as they were, ``edits_applied`` 0."""
    name, n, ce = CORPUS[0]
    (au, av), = _absent(np.random.default_rng(23), n, ce, 1)
    pu, pv = (int(x) for x in ce[0])
    steps = [("delete", au, av), ("insert", pu, pv), ("insert", 4, 4)]
    res = _check(n, ce, PHI0[name], steps)
    assert res.stats.edits_applied == 0 and res.graph.m == len(ce)
    np.testing.assert_array_equal(res.phi, PHI0[name])


def test_input_errors(tmp_path):
    """Bad edits and a phi of the wrong length raise; ``mesh=`` (a one-rank
    gloo mesh in this process) maintains as the reference does."""
    from tests.torch_mesh import one_rank_mesh

    name, n, ce = CORPUS[0]
    with pytest.raises(ValueError, match="insert.*delete"):
        tm.truss_maintain((n, ce), PHI0[name], [("upsert", 0, 1)],
                          device="cpu")
    with pytest.raises(ValueError, match="entries"):
        tm.truss_maintain((n, ce), PHI0[name][:-1], [("insert", 0, 1)],
                          device="cpu")
    with one_rank_mesh(tmp_path) as mesh:
        res = tm.truss_maintain((n, ce), PHI0[name], [], mesh=mesh,
                                device="cpu")
        np.testing.assert_array_equal(res.phi, PHI0[name])
        _check(n, ce, PHI0[name], _steps("mixed", n, ce, seed=7),
               mesh=mesh, mesh_axis="data")


def test_truss_decompose_edits_dispatch():
    """``truss_decompose(edits=)`` maintains from a decomposition of the
    pre-edit graph, or from ``phi0``; ``phi0`` alone raises."""
    name, n, ce = CORPUS[0]
    steps = _steps("mixed", n, ce, seed=31)
    ref = _check(n, ce, PHI0[name], steps)
    phi1 = tpeel.truss_decompose(n, ce, edits=steps, device="cpu")
    np.testing.assert_array_equal(phi1, ref.phi)
    phi2, stats = tpeel.truss_decompose(n, ce, edits=steps,
                                        phi0=PHI0[name], with_stats=True,
                                        device="cpu")
    np.testing.assert_array_equal(phi2, ref.phi)
    assert stats.edits_applied == len(steps)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")    # partition budget warnings
        phi3 = tpeel.truss_decompose(n, ce, edits=steps, engine="bottom-up",
                                     memory_budget=64, device="cpu")
    np.testing.assert_array_equal(phi3, ref.phi)
    with pytest.raises(ValueError, match="phi0"):
        tpeel.truss_decompose(n, ce, phi0=PHI0[name], device="cpu")


@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_edits_digest_and_run_key_equal_reference(name, n, ce):
    steps = _steps("mixed", n, ce, seed=29)
    digest = tm._edits_digest(steps)
    assert digest == jm._edits_digest(steps)
    kw = dict(budget=0, partitioner="none", partitioner_seed=0,
              edits=digest)
    assert tbu._run_key("maintain", n, ce, **kw) == \
        jbu._run_key("maintain", n, ce, **kw)


def test_injected_error_resumes_to_oracle(tmp_path):
    """An error at the fourth ``maintain`` check (the same context in both
    packages) leaves three journaled edits; the resume replays the rest."""
    name, n, ce = CORPUS[3]
    steps = _steps("mixed", n, ce, seed=37)
    logs = []
    for mod, fmod, kw in ((jm, jfaults, {}), (tm, faults,
                                             dict(device="cpu"))):
        d = str(tmp_path / mod.__name__)
        plan = fmod.FaultPlan([fmod.FaultRule(site=fmod.MAINTAIN,
                                              kind="error", nth=4)])
        with fmod.active(plan), pytest.raises(fmod.InjectedFault):
            mod.truss_maintain((n, ce), PHI0[name], steps, checkpoint_dir=d,
                               checkpoint_every=1, **kw)
        logs.append(plan.log)
    assert logs[1] == logs[0]
    assert logs[1][0]["ctx"]["edit"] == 3
    d = str(tmp_path / tm.__name__)
    res = tm.truss_maintain((n, ce), PHI0[name], steps, checkpoint_dir=d,
                            resume=True, device="cpu")
    assert res.stats.resumed_round == 2
    np.testing.assert_array_equal(
        res.phi, alg2_truss(n, _final_edges(n, ce, steps)))
    assert res.stats.edits_applied == len(steps)


def test_foreign_journal_refused(tmp_path):
    """A journal of a decomposition run (another run key and stage) is
    refused, as is a maintenance journal of another edit list."""
    name, n, ce = CORPUS[0]
    d = str(tmp_path / "bu")
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tbu.bottom_up_decompose(n, ce, budget=64, checkpoint_dir=d,
                                checkpoint_every=1, device="cpu")
    with pytest.raises(ValueError):
        tm.truss_maintain((n, ce), PHI0[name], [("insert", 0, 1)],
                          checkpoint_dir=d, resume=True, device="cpu")
    d2 = str(tmp_path / "maint")
    tm.truss_maintain((n, ce), PHI0[name], _steps("insert", n, ce, 3),
                      checkpoint_dir=d2, device="cpu")
    with pytest.raises(ValueError, match="different run"):
        tm.truss_maintain((n, ce), PHI0[name], _steps("insert", n, ce, 5),
                          checkpoint_dir=d2, resume=True, device="cpu")


def test_journal_stage_checked(tmp_path, monkeypatch):
    """A snapshot under the maintenance run key but of another stage is
    refused (the reference's message)."""
    name, n, ce = CORPUS[0]
    steps = _steps("insert", n, ce, 3)
    d = str(tmp_path)
    key = tbu._run_key("maintain", n, ce, budget=0, partitioner="none",
                       partitioner_seed=0, edits=tm._edits_digest(steps))
    tbu.RoundJournal(d, key).record("lb", 0, {"phi": PHI0[name]},
                                    tbu.OocStats())
    with pytest.raises(ValueError, match="not a maintenance"):
        tm.truss_maintain((n, ce), PHI0[name], steps, checkpoint_dir=d,
                          resume=True, device="cpu")


@pytest.mark.parametrize("name,n,ce", CORPUS[:4], ids=IDS[:4])
def test_spilled_store_edits_equal_reference(tmp_path, name, n, ce):
    """Edits on a spilled disk-store graph: the reference's phi and write
    counters, the successor spilled before its predecessor is released (no
    chunk file of the result is lost), the caller's graph kept."""
    steps = _steps("mixed", n, ce, seed=29)
    out = []
    for mod, smod, kw in ((jm, jstore, {}), (tm, tstore,
                                             dict(device="cpu"))):
        with smod.ChunkedDiskStore(str(tmp_path / mod.__name__),
                                   chunk_bytes=1 << 10) as store:
            res = mod.truss_maintain((n, ce), PHI0[name], steps,
                                     store=store, **kw)
            res.graph.unload()
            edges = res.graph.edges.copy()      # read back from the store
        out.append((res, edges))
    (j, je), (t, te) = out
    np.testing.assert_array_equal(te, je)
    np.testing.assert_array_equal(t.phi, j.phi)
    for f in COUNTERS + ("chunk_writes", "bytes_spilled"):
        assert getattr(t.stats, f) == getattr(j.stats, f), f
    assert t.stats.chunk_writes > 0


def test_store_graph_input_keeps_caller_graph(tmp_path):
    """A store-backed ``Graph`` passed in keeps its store, and the caller's
    graph stays readable after the maintenance released its successors."""
    name, n, ce = CORPUS[1]
    steps = _steps("mixed", n, ce, seed=53)
    with tstore.ChunkedDiskStore(str(tmp_path), chunk_bytes=1 << 10) as st_:
        g = tgraph.build_graph(n, ce, store=st_)
        res = tm.truss_maintain(g, PHI0[name], steps, device="cpu")
        g.unload()
        np.testing.assert_array_equal(g.edges, ce)
        assert res.stats.chunk_writes > 0
        np.testing.assert_array_equal(
            res.phi, alg2_truss(n, _final_edges(n, ce, steps)))


_KILL_CHILD = r"""
import json, sys
sys.modules["jax"] = None          # the child imports only repro_torch
sys.modules["repro"] = None
import numpy as np
from repro_torch.core import faults
from repro_torch.core.maintain import truss_maintain

d, nth = sys.argv[1], int(sys.argv[2])
edges = np.load(d + "/edges.npy")
phi0 = np.load(d + "/phi0.npy")
n, steps = json.load(open(d + "/steps.json"))
if nth >= 0:
    faults.install(faults.FaultPlan([faults.FaultRule(
        site=faults.MAINTAIN, kind="kill", nth=nth)]))
res = truss_maintain((n, edges), phi0, [tuple(s) for s in steps],
                     checkpoint_dir=d + "/ckpt", checkpoint_every=1,
                     resume=True, device="cpu")
np.save(d + "/phi.npy", res.phi)
np.save(d + "/final.npy", res.graph.edges)
print("resumed_round", res.stats.resumed_round)
"""


def test_sigkill_mid_maintenance_and_resume(tmp_path):
    """SIGKILL a child (importing only repro_torch) before its fifth edit,
    then resume in a second child: only the edits after the journal's last
    one are replayed, and phi equals the oracle on the final edges."""
    name, n, ce = CORPUS[1]
    steps = _steps("mixed", n, ce, seed=7)
    d = str(tmp_path)
    np.save(d + "/edges.npy", ce)
    np.save(d + "/phi0.npy", PHI0[name])
    with open(d + "/steps.json", "w") as f:
        json.dump([n, steps], f)
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    kill = subprocess.run([sys.executable, "-c", _KILL_CHILD, d, "5"],
                          env=env, capture_output=True, text=True,
                          timeout=300)
    assert kill.returncode == -9, (kill.returncode, kill.stderr[-2000:])
    assert not os.path.exists(d + "/phi.npy")     # it died mid-batch
    resume = subprocess.run([sys.executable, "-c", _KILL_CHILD, d, "-1"],
                            env=env, capture_output=True, text=True,
                            timeout=300)
    assert resume.returncode == 0, resume.stderr[-2000:]
    assert int(resume.stdout.split()[-1]) == 3    # edits 0-3 journaled
    final = np.load(d + "/final.npy")
    np.testing.assert_array_equal(final, _final_edges(n, ce, steps))
    np.testing.assert_array_equal(np.load(d + "/phi.npy"),
                                  alg2_truss(n, final))


_HN = 14


@settings(max_examples=12, deadline=None)
@given(st.lists(st.tuples(st.booleans(), st.integers(0, _HN - 1),
                          st.integers(0, _HN - 1)),
                min_size=1, max_size=10))
def test_edit_streams_equal_reference(ops):
    """Arbitrary edit streams (duplicates, self loops, re-inserting a
    deleted edge, deleting an absent one) equal the reference and the
    oracle."""
    rng = np.random.default_rng(43)
    mask = rng.random((_HN, _HN)) < 0.3
    iu = np.triu_indices(_HN, 1)
    ce = tgraph.canonical_edges(np.stack(iu, 1)[mask[iu]], _HN)
    steps = [("insert" if ins else "delete", u, v) for ins, u, v in ops]
    _check(_HN, ce, alg2_truss(_HN, ce), steps)
