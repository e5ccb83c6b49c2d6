"""TRK102 falsy-zero guards and TRK103 bare asserts.

The reference's two guard rules, with their meaning unchanged; the port
keeps them because both classes shipped in the truss stack before they
were rules:

* ``truss_decompose`` silently routed to the default engine because
  ``if memory_budget:`` conflated ``memory_budget=0`` (a user error worth
  a loud ``ValueError``) with ``memory_budget=None`` (use the default) —
  the decomposition "worked" with the wrong engine.
* ``checkpoint.restore`` validated snapshots with bare ``assert``, which
  ``python -O`` compiles out — the corrupt snapshot loaded anyway.
"""

from __future__ import annotations

import ast
from typing import List, Set

from repro_torch.analysis import framework as fw


def _suspect_names(func: ast.AST, config) -> Set[str]:
    """Parameter names of ``func`` that are numeric-config shaped: either
    annotated optional-numeric or matching the configured name patterns."""
    out: Set[str] = set()
    if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
        return out
    pat = config.numeric_config_re()
    args = func.args
    for a in (args.posonlyargs + args.args + args.kwonlyargs):
        if fw.is_optional_numeric_annotation(a.annotation):
            out.add(a.arg)
        elif pat.fullmatch(a.arg):
            out.add(a.arg)
    return out


class FalsyZeroGuardRule(fw.Rule):
    """TRK102: numeric config values tested with bare truthiness.

    ``if budget:`` / ``not budget`` / ``budget or default`` treat a
    legitimate 0 exactly like None — the caller asked for zero and
    silently got the fallback.  Guard with ``is not None`` (and validate
    non-positive values loudly).
    """

    rule_id = "TRK102"
    summary = ("numeric config tested for truthiness instead of "
               "`is not None` (0 silently becomes the fallback)")

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        findings: List[fw.Finding] = []
        pat = config.numeric_config_re()

        def suspect(expr: ast.AST) -> str:
            """The offending identifier if ``expr`` is a bare truthiness
            read of a numeric-config name ('' otherwise)."""
            if isinstance(expr, ast.UnaryOp) and isinstance(expr.op, ast.Not):
                return suspect(expr.operand)
            if isinstance(expr, ast.Name):
                if pat.fullmatch(expr.id):
                    return expr.id
                func = fw.enclosing_function(expr)
                if func is not None and expr.id in _suspect_names(func,
                                                                  config):
                    return expr.id
            if isinstance(expr, ast.Attribute) and pat.fullmatch(expr.attr):
                return fw.dotted_name(expr)
            return ""

        def flag(expr: ast.AST, context: str) -> None:
            name = suspect(expr)
            if name:
                findings.append(self.finding(
                    module, expr,
                    f"`{name}` is a numeric config value tested for "
                    f"truthiness ({context}); 0 and None take the same "
                    f"branch — use `{name} is not None` and reject "
                    f"non-positive values explicitly"))

        for node in ast.walk(module.tree):
            if isinstance(node, (ast.If, ast.While, ast.IfExp)):
                flag(node.test, "branch condition")
            elif isinstance(node, ast.BoolOp):
                op = "or" if isinstance(node.op, ast.Or) else "and"
                # every operand but the last is a short-circuit *test*;
                # `x or default` / `x and y` both swallow a falsy zero
                for value in node.values[:-1]:
                    flag(value, f"`{op}` short-circuit")
        return findings


class BareAssertRule(fw.Rule):
    """TRK103: ``assert`` in library code — a no-op under ``python -O``.

    Under ``python -O`` an assert in ``src/repro_torch`` is a check that
    silently stops existing, in exactly the run meant to prove recovery
    works.  Raise a typed exception instead (``ValueError`` for
    argument/shape contracts, as ``checkpoint.restore`` does).
    """

    rule_id = "TRK103"
    summary = "bare `assert` in library code (erased under python -O)"

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        norm = module.path.replace("\\", "/")
        if not any(root in norm for root in config.library_roots):
            return []
        findings: List[fw.Finding] = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assert):
                test_src = ast.get_source_segment(module.source, node.test)
                shown = (test_src or "<condition>").replace("\n", " ")
                if len(shown) > 60:
                    shown = shown[:57] + "..."
                findings.append(self.finding(
                    module, node,
                    f"bare assert `{shown}` is compiled out under -O; "
                    f"raise a typed exception (ValueError/TypeError) so "
                    f"the contract survives every CI lane"))
        return findings
