"""Deterministic fault injection for the out-of-core engines.

Port of ``repro.core.faults``.  The injection sites are named once —

* ``"dispatch"``      — entry of a device peel (``peel_classes_batched`` /
  ``local_threshold_peel``), before anything is uploaded;
* ``"finalize"``      — inside ``PendingPeel.result()``, before the copy to
  the host (a failure here poisons the handle);
* ``"checkpoint-write"`` — inside ``checkpoint.manager.save`` after the
  array payload is on disk but before the manifest/rename commit point;
* ``"partitioner"``   — start of each partition round, before the
  partitioner runs (the host-side "crash between rounds" site);
* ``"support"``       — entry of a triangle-credit computation in
  ``partitioned_support`` (per bucket, before any credit is folded into the
  global ``sup``: the credits are not idempotent);
* ``"chunk-read"`` / ``"chunk-write"`` — the graph store's chunk I/O in
  ``core.store.ChunkedDiskStore`` (context ``key``, ``chunk``, ``path``),
  before a chunk file is read or committed;
* ``"maintain"`` — the start of each single-edit step of
  ``core.maintain.truss_maintain`` (context ``edit``, ``op``, ``u``,
  ``v``), after the previous edit's phi was journaled.

— and a test describes failures declaratively as a :class:`FaultPlan`:
*at the 2nd stage-1 dispatch of round 3, raise a device OOM, twice*.  Rules
match on the site name plus any subset of the context keys the site reports
(stage, round, k, retry, ...), fire deterministically, and record what fired
in ``plan.log``.  The sites report the same context keys as the JAX
package's, so one plan hits the same event in both.

Fault kinds:

* ``"oom"``      — raise a ``torch.OutOfMemoryError`` (what the caching
  allocator raises on a real device OOM) whose message says it was
  injected; :func:`is_retryable` accepts it, so the drivers' lane-split /
  degrade ladder engages.
* ``"error"``    — raise :class:`InjectedFault` (not retryable): a poisoned
  computation or host bug, which the drivers must propagate.
* ``"truncate"`` — at the checkpoint-write site only: truncate the array
  payload on disk and return, so the snapshot commits corrupted and the
  manifest checksum must catch it at restore time.
* ``"crash"``    — raise ``OSError`` at the site (at the checkpoint-write
  site: dies before the rename, leaving only a ``.tmp`` directory).
* ``"kill"``     — ``SIGKILL`` the current process (no atexit, no finally
  blocks): the crash-and-resume smoke.

The active plan is process-global, installed with the :func:`active`
context manager (tests) or :func:`install` (subprocess drivers).  With no
plan installed every ``check`` is a no-op costing one attribute load.
"""

from __future__ import annotations

import contextlib
import dataclasses
import os
import signal
from typing import Any, Dict, List, Optional

import torch

# site names (any string is accepted; these are the ones the engines report)
DISPATCH = "dispatch"
FINALIZE = "finalize"
CHECKPOINT_WRITE = "checkpoint-write"
PARTITIONER = "partitioner"
SUPPORT = "support"
CHUNK_READ = "chunk-read"
CHUNK_WRITE = "chunk-write"
MAINTAIN = "maintain"

_RETRYABLE_MARKERS = ("RESOURCE_EXHAUSTED", "OUT_OF_MEMORY", "out of memory",
                      "Out of memory")


class InjectedFault(RuntimeError):
    """A deliberately injected non-retryable failure (kind="error")."""


def make_oom(site: str, ctx: Dict[str, Any]) -> BaseException:
    """A ``torch.OutOfMemoryError``, the class a real allocation failure on
    the card raises, marked as injected."""
    return torch.OutOfMemoryError(
        f"RESOURCE_EXHAUSTED: injected device OOM at site={site!r} "
        f"ctx={ctx!r}")


def is_retryable(exc: BaseException) -> bool:
    """Whether a failure is worth a rebuild-and-retry.

    Retryable: device memory exhaustion — a ``torch.OutOfMemoryError``, or a
    ``RuntimeError`` whose first line (its summary, not attached tool
    output) carries an out-of-memory marker, as a kernel entry's
    ``CUDA error 2 (out of memory)`` does.  Shrinking the dispatch can fix
    these.  Everything else propagates: :class:`InjectedFault`, a CUDA
    launch failure or illegal address (sticky: the context is gone, and a
    retry would hide a kernel bug), a failed ``nvcc`` build, a poisoned
    ``PendingPeel``.
    """
    if isinstance(exc, InjectedFault):
        return False
    if isinstance(exc, torch.OutOfMemoryError):
        return True
    if not isinstance(exc, RuntimeError):
        return False
    head = str(exc).split("\n", 1)[0]
    return any(marker in head for marker in _RETRYABLE_MARKERS)


@dataclasses.dataclass
class FaultRule:
    """One deterministic failure: fire ``times`` times starting at the
    ``nth`` call that matches ``site`` + ``where``.

    ``where`` is a subset match against the context keys the site reports
    (e.g. ``{"stage": 1, "round": 3}``); an empty ``where`` matches every
    call at the site.  Sites report a ``retry`` key on re-dispatches, so a
    rule with ``times > 1`` and no ``where`` constraint on ``retry`` keeps
    failing retries too — that is how tests drive the drivers down the
    whole degradation ladder.
    """

    site: str
    kind: str = "oom"               # oom | error | truncate | crash | kill
    where: Dict[str, Any] = dataclasses.field(default_factory=dict)
    nth: int = 1                    # 1-based index of the first firing match
    times: int = 1                  # how many matching calls to fail
    seen: int = 0                   # matching calls observed (internal)
    fired: int = 0                  # failures delivered (internal)

    def matches(self, site: str, ctx: Dict[str, Any]) -> bool:
        if site != self.site:
            return False
        return all(k in ctx and ctx[k] == v for k, v in self.where.items())


@dataclasses.dataclass
class FaultPlan:
    """An ordered set of :class:`FaultRule`; ``log`` records every firing
    as ``{site, kind, ctx}`` for test assertions."""

    rules: List[FaultRule]
    log: List[Dict[str, Any]] = dataclasses.field(default_factory=list)

    def check(self, site: str, ctx: Dict[str, Any]) -> None:
        for rule in self.rules:
            if not rule.matches(site, ctx):
                continue
            rule.seen += 1
            if rule.seen < rule.nth or rule.fired >= rule.times:
                continue
            rule.fired += 1
            self.log.append({"site": site, "kind": rule.kind,
                             "ctx": dict(ctx)})
            self._deliver(rule, site, ctx)
            return  # at most one failure per call

    def _deliver(self, rule: FaultRule, site: str, ctx: Dict[str, Any]):
        if rule.kind == "oom":
            raise make_oom(site, ctx)
        if rule.kind == "error":
            raise InjectedFault(
                f"injected non-retryable fault at site={site!r} ctx={ctx!r}")
        if rule.kind == "crash":
            raise OSError(f"injected crash at site={site!r} ctx={ctx!r}")
        if rule.kind == "kill":
            os.kill(os.getpid(), signal.SIGKILL)  # no cleanup, by design
        if rule.kind == "truncate":
            path = ctx.get("path")
            if path and os.path.exists(path):
                size = os.path.getsize(path)
                with open(path, "r+b") as f:
                    f.truncate(max(size // 2, 1))
            return  # torn write: the save commits a corrupted payload
        raise ValueError(f"unknown fault kind {rule.kind!r}")


_ACTIVE: Optional[FaultPlan] = None


def install(plan: Optional[FaultPlan]) -> None:
    """Install ``plan`` process-wide (None uninstalls).  Subprocess drivers
    use this; tests prefer the :func:`active` context manager."""
    global _ACTIVE
    _ACTIVE = plan


@contextlib.contextmanager
def active(plan: FaultPlan):
    """Scoped installation: the plan is active inside the with-block only."""
    global _ACTIVE
    prev = _ACTIVE
    _ACTIVE = plan
    try:
        yield plan
    finally:
        _ACTIVE = prev


def check(site: str, **ctx: Any) -> None:
    """The injection site hook: no-op unless a plan is installed."""
    plan = _ACTIVE
    if plan is not None:
        plan.check(site, ctx)
