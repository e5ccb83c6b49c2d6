"""Fault injection in the PyTorch port, against ``repro``.

Mirrors ``tests/test_faults.py`` on ``repro_torch``: the FaultPlan
machinery, the retry classification of ``torch`` errors, and the drivers'
retry / degradation ladders under injected device OOMs.  The same plan is
installed in both packages, one run each: phi must equal the serial oracle
and the reference's, and ``retries`` / ``degraded`` (and, where the run
stops, which sites fired with which context) must equal the reference's.
The port runs on the CPU (``device="cpu"``).
"""

import contextlib
import copy
import warnings

import numpy as np
import pytest
import torch

from repro.core import bottom_up as jbu
from repro.core import faults as jfaults
from repro.core import top_down as jtd
from repro.core.partition import PartitionBudgetWarning
from repro.core.serial import alg2_truss
from repro_torch.core import bottom_up as tbu
from repro_torch.core import faults
from repro_torch.core import partition as tpart
from repro_torch.core import top_down as ttd
from repro_torch.core.peel import PendingPeel
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
_ORACLE = {name: alg2_truss(n, ce) for name, n, ce in CORPUS}
BUDGET = 64
CPU = dict(device="cpu")


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PartitionBudgetWarning)
        warnings.simplefilter("ignore", tpart.PartitionBudgetWarning)
        yield


def _plans(**rule):
    """The same one-rule plan for each package."""
    return (jfaults.FaultPlan([jfaults.FaultRule(**copy.deepcopy(rule))]),
            faults.FaultPlan([faults.FaultRule(**copy.deepcopy(rule))]))


def _both(jfn, tfn, plan_rule, *args, **kw):
    """Run the reference and the port under equal plans; returns
    ``((jres, jplan), (tres, tplan))``."""
    jplan, tplan = _plans(**plan_rule)
    with _quiet(), jfaults.active(jplan):
        jres = jfn(*args, **kw)
    with _quiet(), faults.active(tplan):
        tres = tfn(*args, **kw, **CPU)
    return (jres, jplan), (tres, tplan)


def _ctxs(plan):
    return [(e["site"], e["ctx"]) for e in plan.log]


# ---------------------------------------------------------------- plan unit

def test_rule_subset_match_nth_times():
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.DISPATCH, kind="error", where={"stage": 1},
        nth=2, times=2)])
    fired = 0
    for i in range(6):
        try:
            plan.check(faults.DISPATCH, {"stage": 1, "round": i})
        except faults.InjectedFault:
            fired += 1
    assert fired == 2                      # nth=2 skips the first match
    assert plan.rules[0].seen == 6
    assert [e["ctx"]["round"] for e in plan.log] == [1, 2]


def test_rule_ignores_other_sites_and_ctx():
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.FINALIZE, kind="error", where={"stage": 2})])
    plan.check(faults.DISPATCH, {"stage": 2})          # wrong site
    plan.check(faults.FINALIZE, {"stage": 1})          # wrong ctx value
    plan.check(faults.FINALIZE, {})                    # key absent
    assert plan.log == []
    with pytest.raises(faults.InjectedFault):
        plan.check(faults.FINALIZE, {"stage": 2, "k": 5})


def test_site_names_equal_reference():
    for name in ("DISPATCH", "FINALIZE", "CHECKPOINT_WRITE", "PARTITIONER",
                 "SUPPORT", "CHUNK_READ", "CHUNK_WRITE", "MAINTAIN"):
        assert getattr(faults, name) == getattr(jfaults, name), name


def test_oom_is_retryable_injected_is_not():
    oom = faults.make_oom("dispatch", {"stage": 1})
    assert isinstance(oom, torch.OutOfMemoryError)
    assert faults.is_retryable(oom)
    assert "RESOURCE_EXHAUSTED" in str(oom) and "injected" in str(oom)
    assert faults.is_retryable(torch.OutOfMemoryError("CUDA out of memory"))
    assert not faults.is_retryable(faults.InjectedFault("x"))
    assert not faults.is_retryable(ValueError("RESOURCE_EXHAUSTED"))
    assert faults.is_retryable(RuntimeError("... Out of memory ..."))
    assert faults.is_retryable(RuntimeError(
        "frontier_peel_live_round: CUDA error 2 (out of memory)"))
    assert not faults.is_retryable(RuntimeError("shape mismatch"))


def test_sticky_cuda_errors_and_build_failures_are_not_retryable():
    for msg in ("CUDA error: an illegal memory access was encountered",
                "frontier_peel_live_round: CUDA error 700 (an illegal "
                "memory access was encountered)",
                "CUDA error: unspecified launch failure",
                "kernel build failed:\nnvcc: ptxas fatal: out of memory"):
        assert not faults.is_retryable(RuntimeError(msg)), msg


def test_poisoned_pending_peel_is_not_retryable():
    def boom():
        raise faults.make_oom("finalize", {})

    h = PendingPeel(boom, False)
    with pytest.raises(torch.OutOfMemoryError) as first:
        h.result()
    assert faults.is_retryable(first.value)
    with pytest.raises(RuntimeError) as again:
        h.result()
    assert not faults.is_retryable(again.value)
    assert again.value.__cause__ is first.value


def test_no_plan_is_noop_and_scoped():
    faults.check(faults.DISPATCH, stage=1)             # no plan: no-op
    plan = faults.FaultPlan([faults.FaultRule(site=faults.DISPATCH,
                                              kind="error")])
    with faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            faults.check(faults.DISPATCH)
    faults.check(faults.DISPATCH)                      # uninstalled again
    faults.install(faults.FaultPlan([faults.FaultRule(
        site=faults.DISPATCH, kind="error")]))
    try:
        with pytest.raises(faults.InjectedFault):
            faults.check(faults.DISPATCH)
    finally:
        faults.install(None)
    faults.check(faults.DISPATCH)


def test_unknown_kind_raises():
    plan = faults.FaultPlan([faults.FaultRule(site="x", kind="nonsense")])
    with pytest.raises(ValueError, match="unknown fault kind"):
        plan.check("x", {})


# ------------------------------------------------------- driver self-healing

@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
@pytest.mark.parametrize("site,where", [
    (faults.DISPATCH, {"stage": 1}),
    (faults.DISPATCH, {"stage": 2}),
    (faults.FINALIZE, {"stage": 1}),
    (faults.FINALIZE, {"stage": 2}),
], ids=["dispatch-s1", "dispatch-s2", "finalize-s1", "finalize-s2"])
def test_bottom_up_recovers_from_oom(name, n, ce, site, where):
    (j, jplan), (t, tplan) = _both(
        jbu.bottom_up_decompose, tbu.bottom_up_decompose,
        dict(site=site, kind="oom", where=dict(where), times=1),
        n, ce, budget=BUDGET)
    assert (t.phi == _ORACLE[name]).all(), name
    np.testing.assert_array_equal(t.phi, j.phi)
    assert _ctxs(tplan) == _ctxs(jplan)
    if tplan.log:                 # graph actually exercised the site
        assert t.stats.retries >= 1, name
    assert (t.stats.retries, t.stats.degraded) == \
        (j.stats.retries, j.stats.degraded)


@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
@pytest.mark.parametrize("site,where", [
    (faults.DISPATCH, {"stage": "td"}),
    (faults.FINALIZE, {"stage": "td"}),
    (faults.SUPPORT, {}),
], ids=["dispatch", "finalize", "support"])
def test_top_down_recovers_from_oom(name, n, ce, site, where):
    (j, jplan), (t, tplan) = _both(
        jtd.top_down_decompose, ttd.top_down_decompose,
        dict(site=site, kind="oom", where=dict(where), times=1),
        n, ce, budget=BUDGET)
    assert (t.phi == _ORACLE[name]).all(), name
    np.testing.assert_array_equal(t.phi, j.phi)
    assert _ctxs(tplan) == _ctxs(jplan)
    if tplan.log:
        assert t.stats.retries >= 1, name
    assert (t.stats.retries, t.stats.degraded) == \
        (j.stats.retries, j.stats.degraded)


def test_repeated_oom_walks_degradation_ladder():
    """Persistent stage-1 OOM: lane splits, then budget halving, then the
    failure propagates once the round budget floor is hit — at the same
    dispatches as in the reference."""
    name, n, ce = CORPUS[0]
    rule = dict(site=faults.DISPATCH, kind="oom", where={"stage": 1},
                times=10**6)
    jplan, tplan = _plans(**rule)
    with _quiet(), jfaults.active(jplan):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            jbu.bottom_up_decompose(n, ce, budget=256)
    with _quiet(), faults.active(tplan):
        with pytest.raises(torch.OutOfMemoryError,
                           match="RESOURCE_EXHAUSTED"):
            tbu.bottom_up_decompose(n, ce, budget=256, **CPU)
    assert len(tplan.log) >= 6
    assert any(e["ctx"].get("retry", 0) for e in tplan.log)
    assert _ctxs(tplan) == _ctxs(jplan)


def test_repeated_support_oom_walks_degradation_ladder():
    """The same ladder for partitioned_support's credit rounds."""
    name, n, ce = CORPUS[0]
    rule = dict(site=faults.SUPPORT, kind="oom", times=10**6)
    jplan, tplan = _plans(**rule)
    with _quiet(), jfaults.active(jplan):
        with pytest.raises(RuntimeError, match="RESOURCE_EXHAUSTED"):
            jbu.partitioned_support(n, ce, 256)
    with _quiet(), faults.active(tplan):
        with pytest.raises(torch.OutOfMemoryError):
            tbu.partitioned_support(n, ce, 256)
    assert any(e["ctx"]["retry"] for e in tplan.log)
    assert _ctxs(tplan) == _ctxs(jplan)


@pytest.mark.parametrize("site,where,fn", [
    (faults.DISPATCH, {"stage": 1}, "bottom_up"),
    (faults.SUPPORT, {}, "support"),
], ids=["stage1", "support"])
def test_oom_then_recovery_mid_ladder(site, where, fn):
    """OOM that clears after a few firings: the run degrades part-way down
    the ladder and still finishes exact, with the reference's counters."""
    name, n, ce = CORPUS[0]
    rule = dict(site=site, kind="oom", where=dict(where), times=3)
    if fn == "bottom_up":
        (j, jplan), (t, tplan) = _both(
            jbu.bottom_up_decompose, tbu.bottom_up_decompose, rule, n, ce,
            budget=256)
        assert (t.phi == _ORACLE[name]).all()
        jst, tst = j.stats, t.stats
    else:
        jplan, tplan = _plans(**rule)
        with _quiet(), jfaults.active(jplan):
            jsup, jst = jbu.partitioned_support(n, ce, 256, with_stats=True)
        with _quiet(), faults.active(tplan):
            tsup, tst = tbu.partitioned_support(n, ce, 256, with_stats=True)
        np.testing.assert_array_equal(tsup, jsup)
    assert tst.retries >= 2
    assert tst.degraded >= 1       # a budget restart
    assert (tst.retries, tst.degraded, tst.rounds) == \
        (jst.retries, jst.degraded, jst.rounds)
    assert _ctxs(tplan) == _ctxs(jplan)


@pytest.mark.parametrize("engine", ["bottom-up", "top-down"])
def test_injected_hard_error_propagates(engine):
    name, n, ce = CORPUS[0]
    fn = (tbu.bottom_up_decompose if engine == "bottom-up"
          else ttd.top_down_decompose)
    where = {"stage": 1} if engine == "bottom-up" else {"stage": "td"}
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.DISPATCH, kind="error", where=where)])
    with _quiet(), faults.active(plan):
        with pytest.raises(faults.InjectedFault):
            fn(n, ce, budget=BUDGET, **CPU)
    # never reported as a retry: the drivers classified it non-retryable
    assert [e for e in plan.log if e["ctx"].get("retry", 0)] == []


def test_partitioner_site_crash_propagates():
    name, n, ce = CORPUS[0]
    plan = faults.FaultPlan([faults.FaultRule(
        site=faults.PARTITIONER, kind="crash", nth=2)])
    with _quiet(), faults.active(plan):
        with pytest.raises(OSError, match="injected crash"):
            tbu.bottom_up_decompose(n, ce, budget=BUDGET, **CPU)
    assert plan.log and plan.log[0]["ctx"]["round"] >= 1
    assert set(plan.log[0]["ctx"]) == {"stage", "round", "budget"}


def test_two_lane_splits_then_success():
    """A stage-1 OOM that fires twice: the first dispatch and the first
    split retry fail, the four-way split succeeds — two retries, no
    degradation (the plan chip_smoke.py runs on the card)."""
    name, n, ce = CORPUS[1]
    (j, jplan), (t, tplan) = _both(
        jbu.bottom_up_decompose, tbu.bottom_up_decompose,
        dict(site=faults.DISPATCH, kind="oom", where={"stage": 1}, times=2),
        n, ce, budget=BUDGET)
    assert (t.phi == _ORACLE[name]).all()
    assert (t.stats.retries, t.stats.degraded) == (2, 0)
    assert (j.stats.retries, j.stats.degraded) == (2, 0)
    assert [e["ctx"]["retry"] for e in tplan.log] == [0, 2]
