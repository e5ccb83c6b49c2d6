"""TRK101 consumed-value safety: the port's counterpart of donation safety.

The reference rule (``repro.analysis.rules_donation``) tracks buffers
donated by ``jax.jit(..., donate_argnums=...)``: once donated, a buffer is
dead, and reading it again (a retried finalize re-running the kernel on
donated inputs) reads freed device memory.  Torch has no donation, so the
keyword does not carry over; the class of bug does, in two forms that the
port's code has:

* **A consumed handle.**  ``PendingPeel.result()`` clears its finalize
  before running it and poisons the handle when it fails, so a second
  ``result()`` on the same handle, a retry, never re-runs the device work:
  it raises.  Statically: once a name's ``result()`` was taken, taking it
  again (later in the same function, or on the next iteration of a loop
  that does not rebuild the handle) is a use of a consumed value.
* **A buffer read and written by one launch.**  A kernel binding that
  writes through some arguments while it reads others
  (``fused_round_live(sup, alive, rm, tris, n_rows, tris_out,
  n_rows_out)`` compacts the live rows of ``tris`` into ``tris_out``) races
  on the card when one buffer is passed at a read and at a write position
  of the same call.  ``_Rows.round`` ping-pongs two distinct buffers and is
  the pattern to follow.

The reference's machinery is kept: statement order approximates control
flow, only *bare names* are tracked through assignments (``b = a`` makes
``b`` an alias of ``a`` until either is rebound), and rebinding a name
clears its taint.  A fresh expression (``torch.empty_like(tris)``) is a
new buffer every call and always safe; two spellings of one attribute or
subscript (``self.tris[0]`` twice) are the same buffer.  Consuming methods
and write-through bindings are configured in ``config.py``; a read in an
earlier ``except`` branch is out of scope, as in the reference — the
runtime consumed/poisoned handle covers that half of the class.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Tuple

from repro_torch.analysis import framework as fw


def _own_nodes(func: ast.AST) -> List[ast.AST]:
    """The nodes of ``func`` outside its nested defs and lambdas (those run
    at another time, so they are not in this scope's linear order)."""
    out = []
    for node in ast.walk(func):
        if node is func:
            continue
        skip = False
        for p in fw.parents(node):
            if p is func:
                break
            if isinstance(p, (ast.FunctionDef, ast.AsyncFunctionDef,
                              ast.Lambda)):
                skip = True
                break
        if not skip:
            out.append(node)
    return out


def _assignments(nodes) -> Tuple[Dict[str, List[int]],
                                 Dict[Tuple[str, int], str]]:
    """Lines where each name is bound, and the bare-name aliases
    (``(b, line) -> a`` for ``b = a``)."""
    lines: Dict[str, List[int]] = {}
    aliases: Dict[Tuple[str, int], str] = {}
    for node in nodes:
        targets: List[ast.AST] = []
        if isinstance(node, ast.Assign):
            targets = node.targets
        elif isinstance(node, (ast.AugAssign, ast.AnnAssign,
                               ast.For, ast.AsyncFor)):
            targets = [node.target]
        elif isinstance(node, ast.withitem) and node.optional_vars:
            targets = [node.optional_vars]
        for t in targets:
            lineno = getattr(node, "lineno", None) or t.lineno
            for name in fw.assigned_names(t):
                lines.setdefault(name, []).append(lineno)
            if (isinstance(node, ast.Assign) and isinstance(t, ast.Name)
                    and isinstance(node.value, ast.Name)):
                aliases[(t.id, lineno)] = node.value.id
    return lines, aliases


class DonationSafetyRule(fw.Rule):
    """TRK101: a consumed handle taken again, or one buffer read and
    written through by the same kernel launch."""

    rule_id = "TRK101"
    summary = ("consumed value reused: a handle's result() taken twice, or "
               "one buffer at a read and a write position of a launch")

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        findings: List[fw.Finding] = []
        for func in ast.walk(module.tree):
            if isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                nodes = _own_nodes(func)
                lines, aliases = _assignments(nodes)
                findings.extend(self._consumed(module, nodes, lines,
                                               config))
                findings.extend(self._aliased(module, nodes, lines, aliases,
                                              config))
        return findings

    # -- consumed handles -----------------------------------------------
    def _consumed(self, module, nodes, lines, config) -> List[fw.Finding]:
        findings: List[fw.Finding] = []
        methods = set(config.consuming_methods)
        calls = [n for n in nodes if isinstance(n, ast.Call)
                 and isinstance(n.func, ast.Attribute)
                 and n.func.attr in methods
                 and isinstance(n.func.value, ast.Name)]
        for call in calls:
            name, method = call.func.value.id, call.func.attr
            rebinds = lines.get(name, [])
            # (a) consumed inside a loop that does not rebuild the handle:
            # iteration 2 takes a spent handle
            for loop in fw.enclosing_loops(call):
                rebuilt = any(loop.lineno <= ln <= loop.end_lineno
                              for ln in rebinds)
                if not rebuilt:
                    findings.append(self.finding(
                        module, call,
                        f"`{name}.{method}()` inside a loop that never "
                        f"rebinds `{name}` — the second iteration takes a "
                        f"consumed handle (a retry of a finalize that "
                        f"already ran); rebuild the handle each iteration "
                        f"or retry by dispatching again"))
                    break
            # (b) taken again later with no rebinding between
            for other in calls:
                if (other is not call and other.func.value.id == name
                        and other.lineno > call.lineno
                        and not any(call.lineno < ln <= other.lineno
                                    for ln in rebinds)):
                    findings.append(self.finding(
                        module, other,
                        f"`{name}.{method}()` taken again after line "
                        f"{call.lineno} consumed `{name}` — keep the first "
                        f"result instead of re-taking the handle"))
                    break
        return findings

    # -- one buffer read and written by one launch ---------------------------
    def _aliased(self, module, nodes, lines, aliases,
                 config) -> List[fw.Finding]:
        findings: List[fw.Finding] = []
        table = config.write_through_bindings
        for call in nodes:
            if not isinstance(call, ast.Call):
                continue
            name = fw.call_name(call).split(".")[-1]
            spec = table.get(name)
            if spec is None:
                continue
            reads, writes = spec
            keys = {i: self._buffer(call.args[i], call.lineno, lines,
                                    aliases)
                    for i in set(reads) | set(writes) if i < len(call.args)}
            clash = sorted({(r, w) for r in reads for w in writes
                            if keys.get(r) is not None
                            and keys.get(r) == keys.get(w)})
            if clash:
                r, w = clash[0]
                findings.append(self.finding(
                    module, call,
                    f"`{ast.unparse(call.args[w])}` is written through by "
                    f"`{name}` (argument {w}) while the same buffer is read "
                    f"at argument {r}: the launch races with itself on the "
                    f"card — write into a second buffer and swap, as "
                    f"`_Rows.round` does"))
        return findings

    @staticmethod
    def _buffer(arg: ast.AST, at: int, lines, aliases) -> Optional[str]:
        """A key naming the buffer ``arg`` is at line ``at`` (None for a
        fresh expression): a bare name with the binding in effect there,
        followed through ``b = a`` aliases to the binding ``a`` had then,
        or the dump of an attribute / subscript chain."""
        if isinstance(arg, ast.Name):
            name, line = arg.id, at
            while True:
                before = [ln for ln in lines.get(name, []) if ln < line]
                last = max(before) if before else 0
                src = aliases.get((name, last))
                if src is None or src == name:
                    return f"name:{name}@{last}"
                name, line = src, last
        if isinstance(arg, (ast.Attribute, ast.Subscript)):
            base = arg
            while isinstance(base, (ast.Attribute, ast.Subscript)):
                base = base.value
            if isinstance(base, ast.Name):
                return "expr:" + ast.dump(arg)
        return None
