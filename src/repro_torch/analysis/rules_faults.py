"""TRK106 fault-site coverage.

The engines fail on purpose (``core/faults.py``, the port's own copy of the
registry): every recovery path is only testable because its failure point
carries a ``faults.check(site, **ctx)`` hook with a *registered* site
name.  The coverage rots in two ways this rule pins down statically:

* a new dispatch/finalize/checkpoint/partitioner code path lands without
  its hook, so fault plans silently can't reach it;
* a hook is added with an unregistered site string, so plans targeting
  the documented sites never match it.

Checks:

1. every ``faults.check(...)`` call names a site registered in
   ``core/faults.py`` (string literal or ``faults.CONSTANT``);
2. the configured functions (``peel_classes_batched``,
   ``PendingPeel.result``, ``_partition_rounds``, ``manager.save``, ...)
   reach a ``faults.check`` hook for their required site: in their own
   body, or one call deep through a function of the same module whose body
   holds it (``_check_dispatch(fault_ctx)``, also when the call sits in a
   ``lambda`` handed on as an argument, as the port's mesh paths defer it
   with ``before=lambda: _check_dispatch(fault_ctx)``);
3. in the out-of-core driver modules, every dispatch-capable peel call
   passes ``fault_ctx=`` so injection plans can target it.
"""

from __future__ import annotations

import ast
from pathlib import Path
from typing import Dict, List, Optional, Set

from repro_torch.analysis import framework as fw

# fallback registry when core/faults.py is out of view (fixture tests run
# the rule on snippets in a temp dir); mirrors the module's constants
_BUILTIN_SITES: Dict[str, str] = {
    "DISPATCH": "dispatch",
    "FINALIZE": "finalize",
    "CHECKPOINT_WRITE": "checkpoint-write",
    "PARTITIONER": "partitioner",
    "SUPPORT": "support",
    "CHUNK_READ": "chunk-read",
    "CHUNK_WRITE": "chunk-write",
    "MAINTAIN": "maintain",
}


def _registered_sites(module: fw.Module, config) -> Dict[str, str]:
    """Constant-name -> site-string registry parsed from the faults
    module, resolved relative to the checked file's repo root."""
    norm = Path(module.path.replace("\\", "/"))
    for parent in norm.parents:
        cand = parent / config.faults_module
        if cand.is_file():
            parsed = fw.parse_module(cand)
            if parsed is None:
                break
            out: Dict[str, str] = {}
            for node in parsed.tree.body:
                if (isinstance(node, ast.Assign)
                        and isinstance(node.value, ast.Constant)
                        and isinstance(node.value.value, str)):
                    for name in fw.assigned_names(node.targets[0]):
                        if name.isupper():
                            out[name] = node.value.value
            if out:
                return out
            break
    return dict(_BUILTIN_SITES)


def _is_faults_check(call: ast.Call) -> bool:
    name = fw.call_name(call)
    parts = name.split(".")
    return parts[-1] == "check" and len(parts) > 1 and "faults" in parts[-2]


def _site_of(call: ast.Call) -> Optional[ast.AST]:
    if call.args:
        return call.args[0]
    for kw in call.keywords:
        if kw.arg == "site":
            return kw.value
    return None


class FaultSiteCoverageRule(fw.Rule):
    """TRK106: fault-injection hooks present and registered."""

    rule_id = "TRK106"
    summary = ("fault-injection site missing, unregistered, or a "
               "dispatch call without fault_ctx=")

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        findings: List[fw.Finding] = []
        sites = _registered_sites(module, config)
        site_values: Set[str] = set(sites.values())
        norm = module.path.replace("\\", "/")
        # module-level defs: the helpers a hooked function may reach
        helpers: Dict[str, ast.AST] = {
            n.name: n for n in module.tree.body
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))}

        # 1. every faults.check names a registered site
        for node in ast.walk(module.tree):
            if not (isinstance(node, ast.Call) and _is_faults_check(node)):
                continue
            site = _site_of(node)
            if site is None:
                findings.append(self.finding(
                    module, node, "faults.check() without a site argument"))
            elif isinstance(site, ast.Constant) and isinstance(site.value,
                                                               str):
                if site.value not in site_values:
                    findings.append(self.finding(
                        module, site,
                        f"fault site {site.value!r} is not registered in "
                        f"{config.faults_module} — plans targeting the "
                        f"documented sites will never match it; register "
                        f"a constant there and reference it"))
            elif isinstance(site, ast.Attribute):
                if site.attr.isupper() and site.attr not in sites:
                    findings.append(self.finding(
                        module, site,
                        f"fault site constant `{fw.dotted_name(site)}` is "
                        f"not defined in {config.faults_module}"))

        # 2. required hooks are reached by the configured functions; a plain
        # name matches module-level defs only, `Class.method` matches the
        # method (AsyncWriter.save delegating to the hooked module-level
        # save must not be required to hook twice)
        for (mod_suffix, func_name), const in (
                config.required_fault_hooks.items()):
            if not norm.endswith(mod_suffix):
                continue
            for node in ast.walk(module.tree):
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    continue
                owner = next((p.name for p in fw.parents(node)
                              if isinstance(p, ast.ClassDef)), None)
                qual = f"{owner}.{node.name}" if owner else node.name
                if qual != func_name:
                    continue
                want = sites.get(const, _BUILTIN_SITES.get(const, ""))
                if not (self._has_hook(node, const, want)
                        or self._hooked_helper(node, helpers, const, want)):
                    findings.append(self.finding(
                        module, node,
                        f"`{func_name}` is a registered fault site but "
                        f"reaches no faults.check({const}) hook, in its "
                        f"body or one call deep in this module — "
                        f"injection plans cannot reach this failure "
                        f"point"))

        # 3. dispatch-capable peel calls in the drivers carry fault_ctx=
        if any(norm.endswith(suffix)
               for suffix in config.fault_instrumented_modules):
            for node in ast.walk(module.tree):
                if not isinstance(node, ast.Call):
                    continue
                name = fw.call_name(node).split(".")[-1]
                if name not in config.fault_instrumented_apis:
                    continue
                if any(kw.arg is None for kw in node.keywords):
                    continue  # **kwargs forwarding
                if "fault_ctx" not in fw.keyword_names(node):
                    findings.append(self.finding(
                        module, node,
                        f"driver dispatch `{name}` without `fault_ctx=`: "
                        f"this site is invisible to fault plans, so its "
                        f"retry/degrade path is untestable — name it "
                        f"with stage/round context"))
        return findings

    @classmethod
    def _hooked_helper(cls, func: ast.AST, helpers: Dict[str, ast.AST],
                       const: str, value: str) -> bool:
        """Whether ``func`` calls (directly, or inside a lambda it builds) a
        module-level function whose own body holds the hook: one call
        deep, so a helper of a helper does not count."""
        for node in ast.walk(func):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Name)):
                continue
            helper = helpers.get(node.func.id)
            if (helper is not None and helper is not func
                    and cls._has_hook(helper, const, value)):
                return True
        return False

    @staticmethod
    def _has_hook(func: ast.AST, const: str, value: str) -> bool:
        for node in ast.walk(func):
            if not (isinstance(node, ast.Call) and _is_faults_check(node)):
                continue
            site = _site_of(node)
            if isinstance(site, ast.Attribute) and site.attr == const:
                return True
            if (isinstance(site, ast.Constant) and value
                    and site.value == value):
                return True
        return False
