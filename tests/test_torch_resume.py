"""Round journaling and resume in the PyTorch port, against ``repro``.

Mirrors ``tests/test_resume.py`` on ``repro_torch``: a decomposition
interrupted after a completed round or level and resumed from its
checkpoint directory must give the phi of an uninterrupted run, which is
also the reference's; and under the same interruption the reference and
the port journal and resume alike (``checkpoints``, ``resumed_round``).
The SIGKILL smoke kills a child process that imports only ``repro_torch``
and resumes in this one.  The locality and store cases of the reference's
file are in ``test_torch_locality.py`` and ``test_torch_store_drivers.py``.
"""

import contextlib
import os
import subprocess
import sys
import warnings
from pathlib import Path

import numpy as np
import pytest

from repro.checkpoint import manager as jckpt
from repro.core import bottom_up as jbu
from repro.core import faults as jfaults
from repro.core import peel as jpeel
from repro.core import top_down as jtd
from repro.core.partition import PartitionBudgetWarning
from repro.core.serial import alg2_truss
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import bottom_up as tbu
from repro_torch.core import faults
from repro_torch.core import graph as tgraph
from repro_torch.core import partition as tpart
from repro_torch.core import peel as tpeel
from repro_torch.core import top_down as ttd
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
_ORACLE = {name: alg2_truss(n, ce) for name, n, ce in CORPUS}
BUDGET = 64
REPO = Path(__file__).resolve().parents[1]
RESUME_FIELDS = ("checkpoints", "resumed_round", "retries", "degraded",
                 "rounds", "scans")


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PartitionBudgetWarning)
        warnings.simplefilter("ignore", tpart.PartitionBudgetWarning)
        yield


def _interrupt(fn, plan, activate, **kwargs):
    """Run ``fn`` under ``plan``; return whether it was cut short."""
    with _quiet(), activate(plan):
        try:
            fn(**kwargs)
        except (faults.InjectedFault, jfaults.InjectedFault, OSError):
            return True
    return False


def _interrupt_and_resume(jfn, tfn, tmp_path, rule, **kw):
    """Interrupt and resume each package in its own directory; returns the
    (reference, port) resumed results and whether the port was cut."""
    out = []
    for pkg, fn, mk, activate, extra in (
            ("j", jfn, jfaults, jfaults.active, {}),
            ("t", tfn, faults, faults.active, dict(device="cpu"))):
        d = str(tmp_path / pkg)
        plan = mk.FaultPlan([mk.FaultRule(**dict(rule))])
        cut = _interrupt(fn, plan, activate, checkpoint_dir=d,
                         checkpoint_every=1, **kw, **extra)
        with _quiet():
            res = fn(checkpoint_dir=d, resume=True, **kw, **extra)
        out.append((res, cut, plan))
    return out


@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
@pytest.mark.parametrize("site,where,nth", [
    (faults.PARTITIONER, {"stage": 1}, 3),      # between stage-1 rounds
    (faults.DISPATCH, {"stage": 2}, 1),         # first stage-2 level
    (faults.DISPATCH, {"stage": 2}, 3),         # mid stage-2
], ids=["s1-round3", "s2-first", "s2-mid"])
def test_bottom_up_interrupt_resume(tmp_path, name, n, ce, site, where, nth):
    (j, jcut, _), (t, tcut, tplan) = _interrupt_and_resume(
        jbu.bottom_up_decompose, tbu.bottom_up_decompose, tmp_path,
        dict(site=site, kind="error", where=dict(where), nth=nth),
        n=n, edges=ce, budget=BUDGET)
    assert (t.phi == _ORACLE[name]).all(), name
    np.testing.assert_array_equal(t.phi, j.phi)
    assert tcut == jcut
    if tplan.log and ckpt.latest_step(str(tmp_path / "t")) is not None:
        assert t.stats.resumed_round >= 0, name
    for f in RESUME_FIELDS:
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)
    assert t.candidate_sizes == j.candidate_sizes


@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
@pytest.mark.parametrize("site,where,nth", [
    (faults.PARTITIONER, {"stage": 1}, 2),      # between support rounds
    (faults.DISPATCH, {"stage": "td"}, 2),      # second class level
], ids=["sup-round2", "td-level2"])
def test_top_down_interrupt_resume(tmp_path, name, n, ce, site, where, nth):
    (j, jcut, _), (t, tcut, _) = _interrupt_and_resume(
        jtd.top_down_decompose, ttd.top_down_decompose, tmp_path,
        dict(site=site, kind="error", where=dict(where), nth=nth),
        n=n, edges=ce, budget=BUDGET)
    assert (t.phi == _ORACLE[name]).all(), name
    np.testing.assert_array_equal(t.phi, j.phi)
    assert tcut == jcut
    assert (t.classes, t.candidate_sizes, t.pruned) == \
        (j.classes, j.candidate_sizes, j.pruned)
    for f in RESUME_FIELDS:
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)


def test_top_down_unbudgeted_resume(tmp_path):
    """Without a budget only the levels are journaled ("td")."""
    name, n, ce = CORPUS[1]
    d = str(tmp_path)
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.DISPATCH, kind="error", where={"stage": "td"}, nth=3)])
    assert _interrupt(ttd.top_down_decompose, plan, faults.active, n=n,
                      edges=ce, checkpoint_dir=d, checkpoint_every=1,
                      device="cpu")
    with _quiet():
        res = ttd.top_down_decompose(n, ce, checkpoint_dir=d, resume=True,
                                     device="cpu")
    assert (res.phi == _ORACLE[name]).all()
    assert res.stats.resumed_round >= 3


def test_resume_empty_dir_is_fresh_run(tmp_path):
    name, n, ce = CORPUS[0]
    with _quiet():
        res = tbu.bottom_up_decompose(n, ce, budget=BUDGET,
                                      checkpoint_dir=str(tmp_path / "none"),
                                      resume=True, device="cpu")
        td = ttd.top_down_decompose(n, ce, budget=BUDGET,
                                    checkpoint_dir=str(tmp_path / "none2"),
                                    resume=True, device="cpu")
    assert (res.phi == _ORACLE[name]).all()
    assert (td.phi == _ORACLE[name]).all()
    assert res.stats.resumed_round == td.stats.resumed_round == -1


def test_resume_checkpoints_continue_sequence(tmp_path):
    """A resumed run keeps journaling: the step counter continues past the
    pre-crash snapshots instead of overwriting them."""
    name, n, ce = CORPUS[0]
    d = str(tmp_path / "ckpt")
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.DISPATCH, kind="error", where={"stage": 2}, nth=1)])
    _interrupt(tbu.bottom_up_decompose, plan, faults.active, n=n, edges=ce,
               budget=BUDGET, checkpoint_dir=d, checkpoint_every=1,
               device="cpu")
    before = ckpt.latest_step(d)
    with _quiet():
        tbu.bottom_up_decompose(n, ce, budget=BUDGET, checkpoint_dir=d,
                                resume=True, device="cpu")
    assert before is not None and ckpt.latest_step(d) > before


def test_corrupt_newest_snapshot_falls_back(tmp_path):
    """A newest snapshot torn on disk costs one interval: the journal warns
    and resumes from the one before."""
    name, n, ce = CORPUS[0]
    d = str(tmp_path)
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.DISPATCH, kind="error", where={"stage": 2}, nth=2)])
    assert _interrupt(tbu.bottom_up_decompose, plan, faults.active, n=n,
                      edges=ce, budget=BUDGET, checkpoint_dir=d,
                      checkpoint_every=1, device="cpu")
    newest = ckpt.latest_step(d)
    payload = os.path.join(d, f"step_{newest:010d}", "arrays.npz")
    with open(payload, "r+b") as f:
        f.truncate(os.path.getsize(payload) // 2)
    with _quiet(), pytest.warns(UserWarning, match="skipping corrupt"):
        res = tbu.bottom_up_decompose(n, ce, budget=BUDGET, checkpoint_dir=d,
                                      resume=True, device="cpu")
    assert (res.phi == _ORACLE[name]).all()
    assert res.stats.resumed_round >= 0


def test_run_key_mismatch_rejected(tmp_path):
    """Resuming a journal recorded for a different graph/config raises."""
    name, n, ce = CORPUS[0]
    d = str(tmp_path / "ckpt")
    with _quiet():
        tbu.bottom_up_decompose(n, ce, budget=BUDGET, checkpoint_dir=d,
                                checkpoint_every=1, device="cpu")
    other = tgraph.canonical_edges(ce[:-2], n)        # different edge list
    for kw in (dict(edges=other, budget=BUDGET),
               dict(edges=ce, budget=BUDGET * 2)):
        with _quiet(), pytest.raises(ValueError, match="different run"):
            tbu.bottom_up_decompose(n, checkpoint_dir=d, resume=True,
                                    device="cpu", **kw)
    with _quiet(), pytest.raises(ValueError, match="different run"):
        ttd.top_down_decompose(n, ce, budget=BUDGET, checkpoint_dir=d,
                               resume=True, device="cpu")


@pytest.mark.parametrize("args", [
    ("bottom_up", 64, "sequential", 0, {}),
    ("bottom_up", 100, "random", 3, {}),
    ("top_down", 64, "sequential", 0, dict(t=None, faithful=False)),
    ("top_down", None, "sequential", 0, dict(t=2, faithful=True)),
], ids=["bu", "bu-random", "td", "td-unbudgeted"])
def test_run_key_equals_reference(args):
    driver, budget, part, seed, extras = args
    for name, n, ce in CORPUS:
        assert tbu._run_key(driver, n, ce, budget, part, seed, devices=1,
                            **extras) == \
            jbu._run_key(driver, n, ce, budget, part, seed, devices=1,
                         **extras), name


def test_parse_every_and_time_gate_equal_reference(tmp_path):
    for every in (1, 3, 0, "30s", "500ms", "5m", "1h", " 2.5 s "):
        assert tbu._parse_every(every) == jbu._parse_every(every), every
    for bad in ("soon", "0s", "-1s"):
        with pytest.raises(ValueError):
            tbu._parse_every(bad)
    now = [0.0]
    j = tbu.RoundJournal(str(tmp_path), "k", every="10s",
                         clock=lambda: now[0])
    st = tbu.OocStats()
    written = []
    for t in (1.0, 5.0, 10.5, 12.0, 21.0):
        now[0] = t
        written.append(j.record("lb", int(t), {"x": np.arange(3)}, st))
    assert written == [False, False, True, False, True]
    assert st.checkpoints == 2 and ckpt.all_steps(str(tmp_path)) == [1, 2]


def test_ooc_stats_round_trip_keeps_floats():
    st = tbu.OocStats(rounds=3, retries=2, resumed_round=5,
                      round_build_s=1.25, peel_s=0.5)
    d = st.as_dict()
    back = tbu.OocStats.from_dict({**d, "from_a_newer_layout": 7})
    assert back == st
    assert isinstance(back.round_build_s, float) and back.round_build_s == 1.25
    assert isinstance(back.rounds, int)
    # the reference's counters are all fields of the port's
    shared = set(d) & set(jbu.OocStats().as_dict())
    assert {"devices", "sharded_rounds", "retries", "degraded",
            "checkpoints", "resumed_round", "chunk_reads", "chunk_writes",
            "bytes_spilled", "prefetch_hits", "prefetch_misses",
            "tri_spill_rows", "tri_reload_peak_rows", "edits_applied",
            "maintain_levels", "affected_edges"} <= shared
    assert set(jbu.OocStats().as_dict()) <= set(d)


@pytest.mark.parametrize("engine", ["bottom-up", "top-down"])
def test_truss_decompose_threads_checkpointing(tmp_path, engine):
    name, n, ce = CORPUS[0]
    d = str(tmp_path / "ckpt")
    kw = dict(engine=engine, memory_budget=BUDGET, with_stats=True,
              device="cpu")
    with _quiet():
        phi0, _ = tpeel.truss_decompose(n, ce, **kw)
        phi1, stats = tpeel.truss_decompose(n, ce, checkpoint_dir=d,
                                            checkpoint_every=1, **kw)
        phi2, stats2 = tpeel.truss_decompose(n, ce, checkpoint_dir=d,
                                             resume=True, max_retries=1,
                                             **kw)
        want = jpeel.truss_decompose(n, ce, engine=engine,
                                     memory_budget=BUDGET)
    assert (phi0 == phi1).all() and (phi0 == phi2).all()
    np.testing.assert_array_equal(phi0, want)
    assert stats.checkpoints > 0
    assert stats2.resumed_round >= 0


def test_truss_decompose_in_memory_warns_and_ignores(tmp_path):
    name, n, ce = CORPUS[0]
    with pytest.warns(UserWarning, match="in-memory"):
        phi = tpeel.truss_decompose(n, ce, engine="dense",
                                    checkpoint_dir=str(tmp_path),
                                    device="cpu")
    assert (phi == _ORACLE[name]).all()
    assert ckpt.latest_step(str(tmp_path)) is None


def test_port_journal_is_readable_by_reference(tmp_path):
    """The port's snapshots hold the reference's arrays and metadata."""
    name, n, ce = CORPUS[1]
    d = str(tmp_path)
    with _quiet():
        tbu.bottom_up_decompose(n, ce, budget=BUDGET, checkpoint_dir=d,
                                checkpoint_every=1, device="cpu")
    tree, meta = jckpt.restore(d)
    assert meta["stage"] == "s2" and set(tree) == {"phi", "lb", "remaining"}
    assert meta["run_key"] == jbu._run_key("bottom_up", n, ce, BUDGET,
                                           "sequential", 0, devices=1)
    np.testing.assert_array_equal(tree["phi"], _ORACLE[name])


_KILL_DRIVER = r"""
import sys
sys.modules["jax"] = None          # the child imports only repro_torch
sys.modules["repro"] = None
import warnings
import numpy as np
from repro_torch.core import faults
from repro_torch.core.bottom_up import bottom_up_decompose
from repro_torch.core.top_down import top_down_decompose

ckpt_dir, graph, engine, kill_nth = sys.argv[1:5]
kill_nth = int(kill_nth)
edges = np.load(graph)
n = int(edges.max()) + 1
if kill_nth >= 0:
    site, where = ((faults.PARTITIONER, {"stage": 1}) if engine == "bu"
                   else (faults.DISPATCH, {"stage": "td"}))
    faults.install(faults.FaultPlan([faults.FaultRule(
        site=site, kind="kill", where=where, nth=kill_nth)]))
warnings.simplefilter("ignore")
fn = bottom_up_decompose if engine == "bu" else top_down_decompose
res = fn(n, edges, budget=64, checkpoint_dir=ckpt_dir, checkpoint_every=1,
         resume=True, device="cpu")
np.save(ckpt_dir + "/phi.npy", res.phi)
print("resumed_round", res.stats.resumed_round)
"""


@pytest.mark.parametrize("engine,nth", [("bu", 4), ("td", 2)])
def test_sigkill_crash_and_resume(tmp_path, engine, nth):
    """SIGKILL the worker (between stage-1 rounds, or at a top-down level),
    resume in a second process; phi must equal the oracle.  Rounds are
    consumed one round late, so at round 4's start rounds 1-2 are
    journaled."""
    name, n, ce = CORPUS[0]
    d = str(tmp_path / "ckpt")
    os.makedirs(d)
    graph = str(tmp_path / "edges.npy")
    np.save(graph, ce)
    assert int(ce.max()) + 1 == n
    env = {"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin",
           "HOME": str(tmp_path)}
    kill = subprocess.run(
        [sys.executable, "-c", _KILL_DRIVER, d, graph, engine, str(nth)],
        env=env, capture_output=True, text=True, timeout=300)
    assert kill.returncode == -9, (kill.returncode, kill.stderr[-2000:])
    assert not os.path.exists(d + "/phi.npy")   # it really died mid-run
    assert ckpt.latest_step(d) is not None
    resume = subprocess.run(
        [sys.executable, "-c", _KILL_DRIVER, d, graph, engine, "-1"],
        env=env, capture_output=True, text=True, timeout=300)
    assert resume.returncode == 0, resume.stderr[-2000:]
    assert int(resume.stdout.split()[-1]) >= 1
    phi = np.load(d + "/phi.npy")
    assert (phi == _ORACLE[name]).all()
