"""``trusscheck --fix``: mechanical rewrites for the two mechanical rules.

Fixable classes (the port's copy of the reference's fixer; the rewrites
are byte-identical to ``repro.analysis.fixes``):

* **TRK102** — bare truthiness tests on numeric config names in ``if`` /
  ``while`` conditions: ``if budget:`` -> ``if budget is not None:``,
  ``if not budget:`` -> ``if budget is None:``; and two-operand ``or``
  defaults on a suspect name: ``x = budget or 64`` ->
  ``x = 64 if budget is None else budget``.
* **TRK103** — single-line ``assert cond, msg`` -> ``if not (cond):
  raise ValueError(msg)`` (``ValueError`` is the default type; pick a
  more specific exception by hand where one fits).

Deliberate limits: only single-line nodes are rewritten (a multi-line
assert keeps its finding); ``and`` chains, attribute suspects
(``cfg.budget``) and ternary conditions are reported but not fixed —
their correct rewrite depends on surrounding intent; comments inside a
rewritten segment are not preserved.  The fixer is idempotent: the fixed
form no longer matches the rule.  Semantics note: the TRK102 rewrite
intentionally *changes* behaviour for 0 — that is the bug being fixed —
so run the tests after fixing; each historical sweep added a loud
``ValueError`` for non-positive values next to the rewritten guard.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import framework as fw

FIXABLE_RULES = ("TRK102", "TRK103")


def _segment(module: fw.Module, node: ast.AST) -> Optional[str]:
    return ast.get_source_segment(module.source, node)


def _single_line(node: ast.AST) -> bool:
    return getattr(node, "end_lineno", None) == node.lineno


def _fix_assert(module: fw.Module, node: ast.Assert) -> Optional[Tuple[int, str]]:
    if not _single_line(node):
        return None
    line = module.line(node.lineno)
    indent = line[:len(line) - len(line.lstrip())]
    test_src = _segment(module, node.test)
    if test_src is None:
        return None
    if node.msg is not None:
        msg_src = _segment(module, node.msg)
        if msg_src is None:
            return None
        # a bare tuple message (`assert c, (a, b)`) becomes the exception
        # payload verbatim; anything else is already an expression
        raise_src = f"raise ValueError({msg_src})"
    else:
        raise_src = f"raise ValueError({test_src!r})"
    fixed = (f"{indent}if not ({test_src}):\n"
             f"{indent}    {raise_src}")
    return node.lineno, fixed


def _suspect_test(test: ast.AST) -> Optional[Tuple[str, bool]]:
    """(name_source, negated) when the condition is a bare name or its
    negation — the only forms the fixer rewrites."""
    if isinstance(test, ast.UnaryOp) and isinstance(test.op, ast.Not):
        inner = _suspect_test(test.operand)
        if inner is not None and not inner[1]:
            return inner[0], True
        return None
    if isinstance(test, ast.Name):
        return test.id, False
    return None


def _fix_truthiness(module: fw.Module, stmt: ast.AST) -> Optional[Tuple[int, str]]:
    test = stmt.test
    if not _single_line(test):
        return None
    got = _suspect_test(test)
    if got is None:
        return None
    name, negated = got
    line = module.line(test.lineno)
    old = _segment(module, test)
    if old is None or old not in line:
        return None
    new = f"{name} is None" if negated else f"{name} is not None"
    return test.lineno, line.replace(old, new, 1)


def _fix_or_default(module: fw.Module, boolop: ast.BoolOp) -> Optional[Tuple[int, str]]:
    if not (isinstance(boolop.op, ast.Or) and len(boolop.values) == 2):
        return None
    first, default = boolop.values
    if not isinstance(first, ast.Name) or not _single_line(boolop):
        return None
    line = module.line(boolop.lineno)
    old = _segment(module, boolop)
    default_src = _segment(module, default)
    if old is None or default_src is None or old not in line:
        return None
    new = f"{default_src} if {first.id} is None else {first.id}"
    return boolop.lineno, line.replace(old, new, 1)


def apply_fixes(path: str, findings: List[fw.Finding]) -> int:
    """Rewrite ``path`` in place for its fixable findings; returns the
    number of fixes applied."""
    wanted: Dict[str, List[fw.Finding]] = {}
    for f in findings:
        if f.path == path and f.rule_id in FIXABLE_RULES and not f.allowlisted:
            wanted.setdefault(f.rule_id, []).append(f)
    if not wanted:
        return 0
    module = fw.parse_module(fw.Path(path))
    if module is None:
        return 0
    lines_102 = {f.line for f in wanted.get("TRK102", ())}
    lines_103 = {f.line for f in wanted.get("TRK103", ())}
    replacements: Dict[int, str] = {}   # lineno -> replacement text

    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assert) and node.lineno in lines_103:
            fix = _fix_assert(module, node)
            if fix is not None:
                replacements[fix[0]] = fix[1]
        elif (isinstance(node, (ast.If, ast.While))
              and node.test.lineno in lines_102
              and node.test.lineno not in replacements):
            fix = _fix_truthiness(module, node)
            if fix is not None:
                replacements[fix[0]] = fix[1]
        elif (isinstance(node, ast.BoolOp) and node.lineno in lines_102
              and node.lineno not in replacements):
            fix = _fix_or_default(module, node)
            if fix is not None:
                replacements[fix[0]] = fix[1]

    if not replacements:
        return 0
    out = list(module.lines)
    for lineno, text in replacements.items():
        out[lineno - 1] = text
    trailing_newline = module.source.endswith("\n")
    new_source = "\n".join(out) + ("\n" if trailing_newline else "")
    fw.Path(path).write_text(new_source, encoding="utf-8")
    return len(replacements)
