"""``trusscheck`` for the port: the repo-native static-analysis pass over
``src/repro_torch``.

The port's own copy of the reference's pass (``repro.analysis``; the port
imports nothing of the JAX package), with the rules that named JAX idiom
re-aimed at the port's: torch tensors where the reference had jax arrays,
``device.host_read`` where it had ``jax.device_get``, kernel bindings over
``ctypes`` where it had ``pallas_call``, shared memory where it had VMEM.
It codifies the bug classes the truss stack has shipped as AST rules: a
falsy-zero config guard, a bare assert erased under ``python -O``, a
consumed handle taken again, launch shapes left uncounted, host syncs in
the round loops, fault-site coverage, and the kernel bindings' launch and
shared-memory invariants.  Run it with::

    python -m repro_torch.analysis [src/repro_torch] [--json report.json] [--fix]

Stdlib only — no torch import, so it runs before any dependency install.
The rule ids, the pragma syntax (``# trusscheck: allow[TRKnnn] -- <why>``),
the report's JSON and the exit codes are the reference's.  The catalog:

========  =======================================================
TRK100    allowlist pragma hygiene (rationale required, no stale
          pragmas) — emitted by the framework itself
TRK101    consumed values: a PendingPeel handle's result() taken
          again (a retry), or one buffer passed to a kernel binding
          at a position it reads and one it writes through
TRK102    falsy-zero guards: numeric config tested for truthiness
TRK103    bare assert in library code (erased under python -O)
TRK104    launch-shape discipline: shape-keyed APIs called in a
          loop without shape_cache=/shape_ladder=, or a locally
          torch.compile'd callable fed loop-varying shapes
TRK105    host syncs on device tensors inside the hot round loops
          (.item/.tolist/.cpu/.numpy, int/float/bool, np.asarray,
          a tensor as a branch test); device.host_read is the one
          counted read and is never flagged
TRK106    fault-site coverage: unregistered sites, missing hooks
          (one call deep through a same-module helper counts),
          dispatches without fault_ctx=
TRK107    CUDA kernel bindings: a live divisibility guard or a
          ceil-div on every launch knob, and a *smem_bytes*
          estimate compared against SMEM_BUDGET_BYTES
========  =======================================================
"""

from __future__ import annotations

from typing import List, Optional, Sequence

from repro_torch.analysis.config import DEFAULT_CONFIG, CheckConfig
from repro_torch.analysis.framework import (Finding, Module, Report, Rule,
                                            run)
from repro_torch.analysis.rules_donation import DonationSafetyRule
from repro_torch.analysis.rules_faults import FaultSiteCoverageRule
from repro_torch.analysis.rules_guards import (BareAssertRule,
                                               FalsyZeroGuardRule)
from repro_torch.analysis.rules_jit import HostSyncRule, RecompileHazardRule
from repro_torch.analysis.rules_kernels import KernelInvariantRule

ALL_RULES = (
    DonationSafetyRule,
    FalsyZeroGuardRule,
    BareAssertRule,
    RecompileHazardRule,
    HostSyncRule,
    FaultSiteCoverageRule,
    KernelInvariantRule,
)


def build_rules(only: Optional[Sequence[str]] = None) -> List[Rule]:
    """Instantiate the catalog, optionally restricted to specific ids."""
    rules = [cls() for cls in ALL_RULES]
    if only is None:
        return rules
    wanted = {r.strip().upper() for r in only if r.strip()}
    unknown = wanted - {r.rule_id for r in rules} - {"TRK100"}
    if unknown:
        raise ValueError(f"unknown rule ids: {sorted(unknown)}")
    return [r for r in rules if r.rule_id in wanted]


def check_paths(paths: Sequence[str], *,
                only: Optional[Sequence[str]] = None,
                config: Optional[CheckConfig] = None) -> Report:
    """Programmatic entry point (the tests drive this)."""
    return run(paths, build_rules(only), config or DEFAULT_CONFIG)


__all__ = [
    "ALL_RULES", "CheckConfig", "DEFAULT_CONFIG", "Finding", "Module",
    "Report", "Rule", "build_rules", "check_paths", "run",
]
