"""TRK107 CUDA kernel-binding invariants.

The port's counterpart of the reference's Pallas rule
(``src/repro/analysis/rules_pallas.py``): the hand-written sm_90a kernels
under ``csrc/`` are launched through ``ctypes`` by binding modules under
``kernels/`` that load their library with ``build.library``, and those
bindings rest on two statically visible contracts:

* **launch divisibility** — every block or tile knob that sizes a launch
  divides the dimension it tiles, or the binding pads up to it.  A launch
  sized by a floor division ``n // K`` drops the remainder of ``n``
  silently: the last rows are never read or written.  The knob must be
  checked in a live guard (``n % K`` in an ``if``/``while``/ternary test
  or a comprehension filter, with a typed raise) or used through a
  ceil-div (``-(-n // K) * K``, ``(n + K - 1) // K``), whose tail the
  kernel masks.  A bare ``assert`` is compiled out under ``python -O``
  (TRK103) and does not count.  Knobs are the divisors (names, not
  literals) of the floor divisions that feed the launch's arguments, in
  the launching function and one call deep into a helper of the same
  module (``group = check_gqa(q, k, v)`` returns ``hq // hkv``), and the
  launching function's tile-shaped parameters passed to the launch.
* **shared-memory budgeting** — the module defines a ``*smem_bytes*``
  estimate of one block's static plus dynamic shared memory, mirroring the
  ``<name>_smem_bytes`` C export of its source, and compares it against
  the budget constant (``SMEM_BUDGET_BYTES``, the card's per-block opt-in
  limit, ``kernels/build.py``).  A launch past the limit fails at run
  time with an error the caller cannot act on; the estimate lets the
  binding refuse it with a message, and lets the smoke hold the estimate
  to the card.

A launch is the call whose return code the binding hands to
``build.check(lib, rc, what)``.

Static limits: the rule proves the *discipline* exists — a guard per knob
and a budget comparison per module — not that the arithmetic inside them
is right; the kernel-against-plain-version checks on the card and the test
that holds each Python estimate to its C formula own that half.
"""

from __future__ import annotations

import ast
import re
from typing import Dict, List, Set, Tuple

from repro_torch.analysis import framework as fw


def _loads_library(module: fw.Module) -> bool:
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Call):
            parts = fw.call_name(node).split(".")
            if parts[-1] == "library" and len(parts) > 1 \
                    and parts[-2] == "build":
                return True
    return False


def _is_build_check(call: ast.Call) -> bool:
    parts = fw.call_name(call).split(".")
    return (len(parts) > 1 and parts[-2] == "build" and parts[-1] == "check"
            and len(call.args) >= 2)


def _launches(module: fw.Module) -> List[Tuple[ast.AST, ast.Call]]:
    """(function, launch call) pairs: the calls whose return code reaches
    ``build.check``."""
    out = []
    for func in ast.walk(module.tree):
        if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        rc_names: Set[str] = set()
        for node in ast.walk(func):
            if isinstance(node, ast.Call) and _is_build_check(node):
                rc = node.args[1]
                if isinstance(rc, ast.Call):
                    out.append((func, rc))
                elif isinstance(rc, ast.Name):
                    rc_names.add(rc.id)
        for node in ast.walk(func):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and set(fw.assigned_names(node.targets[0])) & rc_names):
                out.append((func, node.value))
    return out


def _names_in(node: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(node) if isinstance(n, ast.Name)}


def _bindings(func: ast.AST) -> Dict[str, List[ast.AST]]:
    """Values bound to each name in ``func`` (tuple unpacking binds every
    name to the whole value)."""
    out: Dict[str, List[ast.AST]] = {}
    for node in ast.walk(func):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for name in fw.assigned_names(t):
                    out.setdefault(name, []).append(node.value)
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign)) and \
                node.value is not None:
            for name in fw.assigned_names(node.target):
                out.setdefault(name, []).append(node.value)
    return out


def _closure(roots: List[ast.AST], func: ast.AST) -> List[ast.AST]:
    """``roots`` and every value bound, in ``func``, to a name they use,
    transitively."""
    binds = _bindings(func)
    out, todo, seen = [], list(roots), set()
    while todo:
        expr = todo.pop()
        if id(expr) in seen:
            continue
        seen.add(id(expr))
        out.append(expr)
        for name in _names_in(expr):
            todo.extend(binds.get(name, ()))
    return out


def _sizing_exprs(func: ast.AST, call: ast.Call,
                  helpers: Dict[str, ast.AST]) -> List[ast.AST]:
    """The expressions a launch's arguments are computed from, in the
    launching function and one call deep in a helper of the module."""
    args = list(call.args) + [kw.value for kw in call.keywords]
    exprs = _closure(args, func)
    for expr in list(exprs):
        for node in ast.walk(expr):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            helper = helpers.get(node.func.id)
            if helper is None or helper is func:
                continue
            rets = [r.value for r in ast.walk(helper)
                    if isinstance(r, ast.Return) and r.value is not None]
            exprs.extend(_closure(rets, helper))
    return exprs


def _is_ceil_div(div: ast.BinOp) -> bool:
    """``-(-n // K)`` (checked by the caller through the parent) or
    ``(n + K - 1) // K``: the numerator is a negation, or a sum that holds
    the divisor."""
    left = div.left
    if isinstance(left, ast.UnaryOp) and isinstance(left.op, ast.USub):
        parent = getattr(div, "_trusscheck_parent", None)
        return isinstance(parent, ast.UnaryOp) and isinstance(parent.op,
                                                               ast.USub)
    if isinstance(left, ast.BinOp) and isinstance(left.op, (ast.Add,
                                                            ast.Sub)):
        key = ast.dump(div.right)
        return any(ast.dump(n) == key for n in ast.walk(left))
    return False


def _guard_exprs(module: fw.Module) -> List[ast.AST]:
    """Expressions evaluated as live conditions: if/while/ternary tests
    and comprehension filters.  Asserts are deliberately excluded — they
    vanish under ``python -O`` (the TRK103 class)."""
    out: List[ast.AST] = []
    for node in ast.walk(module.tree):
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            out.append(node.test)
        elif isinstance(node, ast.comprehension):
            out.extend(node.ifs)
    return out


class KernelInvariantRule(fw.Rule):
    """TRK107: kernel bindings must guard launch-sizing divisors and
    budget-check a shared-memory estimate."""

    rule_id = "TRK107"
    summary = ("CUDA kernel binding without a live divisibility guard (or "
               "ceil-div) on a launch knob, or without a shared-memory "
               "estimate compared against SMEM_BUDGET_BYTES")

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        norm = module.path.replace("\\", "/")
        if not any(g in norm for g in config.kernel_globs):
            return []
        if not _loads_library(module):
            return []
        launches = _launches(module)
        findings: List[fw.Finding] = []
        tile_re = config.tile_param_re()
        helpers = {n.name: n for n in module.tree.body
                   if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

        # names (and dotted names) inside a % in a live guard expression
        guarded: Set[str] = set()
        for expr in _guard_exprs(module):
            for node in ast.walk(expr):
                if isinstance(node, ast.BinOp) and isinstance(node.op,
                                                              ast.Mod):
                    for sub in ast.walk(node):
                        if isinstance(sub, (ast.Name, ast.Attribute)):
                            guarded.add(fw.dotted_name(sub))

        # (a) every knob that sizes a launch is guarded or ceil-divided
        for func, call in launches:
            floor: Set[str] = set()
            ceil: Set[str] = set()
            for expr in _sizing_exprs(func, call, helpers):
                for node in ast.walk(expr):
                    if not (isinstance(node, ast.BinOp)
                            and isinstance(node.op, ast.FloorDiv)
                            and isinstance(node.right, (ast.Name,
                                                        ast.Attribute))):
                        continue
                    knob = fw.dotted_name(node.right)
                    (ceil if _is_ceil_div(node) else floor).add(knob)
            params = {a.arg for a in (func.args.posonlyargs + func.args.args
                                      + func.args.kwonlyargs)}
            direct = set().union(*[_names_in(a) for a in call.args]
                                 + [_names_in(k.value)
                                    for k in call.keywords]) \
                if (call.args or call.keywords) else set()
            tiles = {p for p in params & direct if tile_re.fullmatch(p)}
            for knob in sorted((floor | tiles) - ceil - guarded):
                how = ("floor-divides a launch size" if knob in floor
                       else "is passed to the launch")
                findings.append(self.finding(
                    module, call,
                    f"launch knob `{knob}` {how} but no live divisibility "
                    f"check (`n % {knob}` in an if/raise or a candidate "
                    f"filter) and no ceil-div padding path exists in this "
                    f"module — a remainder is silently never launched; "
                    f"guard it with a typed raise (asserts are erased "
                    f"under -O) or pad with -(-n // {knob}) * {knob}"))

        # (b) module-level: a shared-memory estimate compared against the
        # budget constant
        smem_re = re.compile(config.smem_helper_pattern)
        budget_re = re.compile(config.smem_budget_pattern)
        has_helper = any(
            smem_re.fullmatch(node.name)
            for node in ast.walk(module.tree)
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
        ) or any(
            smem_re.fullmatch(alias.name.split(".")[-1])
            for node in ast.walk(module.tree)
            if isinstance(node, (ast.Import, ast.ImportFrom))
            for alias in node.names
        )
        # names bound to an estimate call count as the estimate too
        # (`need = smem_bytes(...); if need > build.SMEM_BUDGET_BYTES:`)
        smem_names: Set[str] = set()
        for node in ast.walk(module.tree):
            if (isinstance(node, ast.Assign)
                    and isinstance(node.value, ast.Call)
                    and smem_re.fullmatch(
                        fw.call_name(node.value).split(".")[-1])):
                smem_names.update(fw.assigned_names(node.targets[0]))

        def is_estimate(side: ast.AST) -> bool:
            if isinstance(side, ast.Call):
                return bool(smem_re.fullmatch(
                    fw.call_name(side).split(".")[-1]))
            return isinstance(side, ast.Name) and side.id in smem_names

        def is_budget(side: ast.AST) -> bool:
            name = fw.dotted_name(side).split(".")[-1]
            return bool(name) and bool(budget_re.fullmatch(name))

        has_compare = any(
            any(is_estimate(s) for s in [node.left, *node.comparators])
            and any(is_budget(s) for s in [node.left, *node.comparators])
            for node in ast.walk(module.tree) if isinstance(node, ast.Compare))
        if not (has_helper and has_compare):
            anchor = launches[0][1] if launches else module.tree
            findings.append(self.finding(
                module, anchor,
                "kernel binding without a shared-memory estimate compared "
                "against the budget: define a `smem_bytes(...)` estimate "
                "of one block's static plus dynamic shared memory (the "
                "source's `<name>_smem_bytes` export) and check it against "
                "SMEM_BUDGET_BYTES before launching"))
        return findings
