"""`trusscheck` rule framework: findings, allowlist pragmas, the runner.

The port's copy of the reference package's framework (``repro.analysis``,
kept apart because the port imports nothing of that package).  The checker
codifies the bug classes the truss stack has shipped (a falsy
``memory_budget`` fallback, a ``PendingPeel`` retry that re-ran a consumed
finalize, bare asserts erased under ``python -O``, ...) as AST rules.
Everything here is stdlib only: the pass runs where neither torch nor a
CUDA toolkit is installed.

A rule is a subclass of :class:`Rule` with a unique ``rule_id``
(``TRK1xx``), a one-line ``summary``, and a ``check(module) -> findings``
method over a parsed :class:`Module`.  Rules are registered in
:data:`repro_torch.analysis.ALL_RULES` (see ``__init__.py``) and selected
on the command line with ``--rules``.

Allowlist pragma
----------------
A finding is suppressed by a pragma on the flagged line or the line
above (rule ids are uppercase; the placeholder here is lowercase so this
docstring is not itself parsed as a pragma)::

    if not bool(overflow):  # trusscheck: allow[TRKnnn] -- <why it is safe>

The rationale after ``--`` is REQUIRED: a pragma without one is itself a
finding (``TRK100``), so every suppression carries its justification in
the source; a pragma that suppresses nothing is flagged as stale.
Multiple ids separate with commas: ``allow[TRKnnn,TRKmmm]``.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import re
import sys
from pathlib import Path
from typing import Dict, Iterable, List, Optional, Sequence

SEVERITY_ERROR = "error"
SEVERITY_WARNING = "warning"

_PRAGMA_RE = re.compile(
    r"#\s*trusscheck:\s*allow\[(?P<ids>[A-Z0-9, ]+)\]"
    r"(?:\s*--\s*(?P<why>.*\S))?")


@dataclasses.dataclass
class Finding:
    """One rule violation at one source location."""

    rule_id: str
    severity: str
    path: str
    line: int
    col: int
    message: str
    allowlisted: bool = False

    def as_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def render(self) -> str:
        tag = " (allowlisted)" if self.allowlisted else ""
        return (f"{self.path}:{self.line}:{self.col}: "
                f"{self.rule_id} [{self.severity}]{tag} {self.message}")


@dataclasses.dataclass
class Pragma:
    """A parsed ``# trusscheck: allow[...]`` comment."""

    line: int
    rule_ids: List[str]
    rationale: str
    used: bool = False


class Module:
    """One parsed source file plus the derived context rules share.

    ``tree`` is the ``ast`` module tree; ``lines`` the raw source lines
    (1-indexed through :meth:`line`); ``pragmas`` the allowlist comments
    keyed by the line they suppress.  Parent links are attached to every
    node (``node._trusscheck_parent``) so rules can walk upward —
    :func:`enclosing_loops` and :func:`enclosing_function` build on it.
    """

    def __init__(self, path: str, source: str, tree: ast.AST):
        self.path = path
        self.source = source
        self.lines = source.splitlines()
        self.tree = tree
        self.pragmas = self._parse_pragmas()
        for parent in ast.walk(tree):
            for child in ast.iter_child_nodes(parent):
                child._trusscheck_parent = parent  # type: ignore[attr-defined]

    def line(self, n: int) -> str:
        if 1 <= n <= len(self.lines):
            return self.lines[n - 1]
        return ""

    def _parse_pragmas(self) -> Dict[int, Pragma]:
        out: Dict[int, Pragma] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _PRAGMA_RE.search(text)
            if m is None:
                continue
            ids = [s.strip() for s in m.group("ids").split(",") if s.strip()]
            out[i] = Pragma(line=i, rule_ids=ids,
                            rationale=(m.group("why") or "").strip())
        return out

    def pragma_for(self, line: int, rule_id: str) -> Optional[Pragma]:
        """The pragma suppressing ``rule_id`` at ``line``: same line, or a
        pragma-only line directly above."""
        for cand in (line, line - 1):
            p = self.pragmas.get(cand)
            if p is None:
                continue
            if cand == line - 1 and not self.line(cand).lstrip().startswith("#"):
                continue  # pragma above must be a standalone comment line
            if rule_id in p.rule_ids:
                return p
        return None


class Rule:
    """Base class: subclasses set ``rule_id``/``summary``/``severity`` and
    implement :meth:`check`."""

    rule_id: str = "TRK000"
    summary: str = ""
    severity: str = SEVERITY_ERROR

    def check(self, module: Module, config) -> List[Finding]:
        raise NotImplementedError

    def finding(self, module: Module, node: ast.AST, message: str) -> Finding:
        return Finding(rule_id=self.rule_id, severity=self.severity,
                       path=module.path, line=getattr(node, "lineno", 1),
                       col=getattr(node, "col_offset", 0) + 1,
                       message=message)


# ---------------------------------------------------------------------------
# shared AST helpers
# ---------------------------------------------------------------------------

def parents(node: ast.AST) -> Iterable[ast.AST]:
    """The chain of ancestors from ``node`` to the module root."""
    cur = getattr(node, "_trusscheck_parent", None)
    while cur is not None:
        yield cur
        cur = getattr(cur, "_trusscheck_parent", None)


def enclosing_loops(node: ast.AST) -> List[ast.AST]:
    """Every for/while statement the node sits inside (function-bounded:
    a loop outside the node's closest enclosing def does not count — the
    closure may run once, elsewhere, later)."""
    out = []
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)):
            break
        if isinstance(p, (ast.For, ast.AsyncFor, ast.While)):
            out.append(p)
    return out


def enclosing_function(node: ast.AST):
    for p in parents(node):
        if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return p
    return None


def call_name(call: ast.Call) -> str:
    """Dotted best-effort name of a call target: ``a.b.c(...)`` ->
    ``"a.b.c"``, ``f(...)`` -> ``"f"``, anything else -> ``""``."""
    return dotted_name(call.func)


def dotted_name(node: ast.AST) -> str:
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Attribute):
        base = dotted_name(node.value)
        return f"{base}.{node.attr}" if base else node.attr
    return ""


def keyword_names(call: ast.Call) -> List[str]:
    return [kw.arg for kw in call.keywords if kw.arg is not None]


def assigned_names(target: ast.AST) -> List[str]:
    """Flat plain names bound by an assignment target (tuples unpacked)."""
    if isinstance(target, ast.Name):
        return [target.id]
    if isinstance(target, (ast.Tuple, ast.List)):
        out: List[str] = []
        for elt in target.elts:
            out.extend(assigned_names(elt))
        return out
    if isinstance(target, ast.Starred):
        return assigned_names(target.value)
    return []


def is_optional_numeric_annotation(ann: Optional[ast.AST]) -> bool:
    """Whether an annotation spells an optional numeric: ``int | None``,
    ``Optional[int]``, ``Optional[float]``, ``float | None`` (and the
    string-literal forms of the same)."""
    if ann is None:
        return False
    if isinstance(ann, ast.Constant) and isinstance(ann.value, str):
        try:
            ann = ast.parse(ann.value, mode="eval").body
        except SyntaxError:
            return False
    numeric = {"int", "float"}
    if isinstance(ann, ast.BinOp) and isinstance(ann.op, ast.BitOr):
        sides = (ann.left, ann.right)
        names = {dotted_name(s) for s in sides}
        has_none = any(isinstance(s, ast.Constant) and s.value is None
                       for s in sides) or "None" in names
        return has_none and bool(names & numeric)
    if isinstance(ann, ast.Subscript) and dotted_name(ann.value).endswith(
            "Optional"):
        inner = ann.slice
        return dotted_name(inner) in numeric
    return False


# ---------------------------------------------------------------------------
# runner
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class Report:
    """The outcome of one run: findings plus unused-pragma diagnostics."""

    findings: List[Finding]
    files_checked: int

    @property
    def active(self) -> List[Finding]:
        return [f for f in self.findings if not f.allowlisted]

    @property
    def errors(self) -> List[Finding]:
        return [f for f in self.active if f.severity == SEVERITY_ERROR]

    def as_json(self) -> str:
        return json.dumps(
            {"files_checked": self.files_checked,
             "findings": [f.as_dict() for f in self.findings],
             "active": len(self.active), "errors": len(self.errors)},
            indent=2, sort_keys=True)


def iter_py_files(paths: Sequence[str]) -> List[Path]:
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_dir():
            out.extend(sorted(path.rglob("*.py")))
        elif path.suffix == ".py":
            out.append(path)
    return [p for p in out if "__pycache__" not in p.parts]


def parse_module(path: Path) -> Optional[Module]:
    try:
        source = path.read_text(encoding="utf-8")
    except (OSError, UnicodeDecodeError) as exc:
        print(f"trusscheck: cannot read {path}: {exc}", file=sys.stderr)
        return None
    try:
        tree = ast.parse(source, filename=str(path))
    except SyntaxError as exc:
        print(f"trusscheck: syntax error in {path}: {exc}", file=sys.stderr)
        return None
    return Module(str(path), source, tree)


def check_module(module: Module, rules: Sequence[Rule], config) -> List[Finding]:
    """Run ``rules`` over one parsed module, applying allowlist pragmas.

    A pragma with an empty rationale yields a TRK100 finding; a pragma
    that suppressed nothing in this run yields one too (stale allowlists
    rot into silent holes, as unexecuted asserts do).
    """
    findings: List[Finding] = []
    for rule in rules:
        for f in rule.check(module, config):
            pragma = module.pragma_for(f.line, f.rule_id)
            if pragma is not None and pragma.rationale:
                f.allowlisted = True
                pragma.used = True
            elif pragma is not None:
                pragma.used = True  # counted, but rationale-less: keep live
                findings.append(Finding(
                    rule_id="TRK100", severity=SEVERITY_ERROR,
                    path=module.path, line=pragma.line, col=1,
                    message=("allowlist pragma without a rationale: append "
                             "'-- <why this is safe>'")))
            findings.append(f)
    checked = {r.rule_id for r in rules}
    for pragma in module.pragmas.values():
        if not pragma.used and set(pragma.rule_ids) & checked:
            findings.append(Finding(
                rule_id="TRK100", severity=SEVERITY_ERROR,
                path=module.path, line=pragma.line, col=1,
                message=(f"stale allowlist pragma: no "
                         f"{','.join(pragma.rule_ids)} finding at this line "
                         "— delete it, or it hides the next regression")))
    return findings


def run(paths: Sequence[str], rules: Sequence[Rule], config) -> Report:
    files = iter_py_files(paths)
    findings: List[Finding] = []
    n = 0
    for path in files:
        module = parse_module(path)
        if module is None:
            continue
        n += 1
        findings.extend(check_module(module, rules, config))
    findings.sort(key=lambda f: (f.path, f.line, f.rule_id))
    return Report(findings=findings, files_checked=n)
