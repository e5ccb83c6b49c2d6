"""TRK104 launch-shape discipline and TRK105 implicit host syncs.

Both rules police the round loops of the out-of-core drivers:

* The drivers key every launch shape through a caller-owned cache
  (``shape_cache=``) or pack onto a shape already launched
  (``shape_ladder=``); ``OocStats.compiles`` counts the distinct launch
  shapes of a run through it.  TRK104 flags calls to the shape-disciplined
  APIs from inside a loop that drop the keyword.  Its second branch is the
  port's counterpart of a locally jitted callable: a ``torch.compile`` /
  ``torch.jit.script`` binding or decorated def of the same file, called in
  a loop with loop-varying arguments, re-specialises on every new shape.
  The port has none; the fixtures hold that branch.
* TRK105 flags host synchronisation on device tensors inside the loops of
  the configured hot modules: ``.item()``, ``.tolist()``, ``.cpu()``,
  ``.numpy()``, ``.to("cpu")``, ``int()``/``float()``/``bool()`` of a
  tensor, ``np.asarray(tensor)``, and a tensor used as an ``if``/``while``
  test.  Each one waits for the card and empties the launch queue.  Device
  values are tracked by taint: names bound to the configured producers
  (the kernel bindings, ``_put``-style uploads, the device-side peels), to
  ``.to(<device>)``, ``.cuda()`` or a torch factory given ``device=``, and
  to tensor expressions over those names.  Host numpy in the same loops is
  not a device value and is not flagged.  ``repro_torch.device.host_read``
  (scalars) and ``host_array`` (a whole tensor) are the sanctioned reads,
  counted in ``device.SYNCS``: they are never flagged, and what they
  return is a host value.
"""

from __future__ import annotations

import ast
import re
from typing import List, Set

from repro_torch.analysis import framework as fw

_SYNC_BUILTINS = {"int", "float", "bool"}
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}
# tensor methods and attributes that answer on the host without a sync
_HOST_METHODS = {"size", "dim", "numel", "nelement", "data_ptr", "stride",
                 "element_size", "is_contiguous", "get_device",
                 "storage_offset"}
_DEVICE_ATTRS = {"T", "mT", "H", "real", "imag", "data", "grad"}


def _loop_varying_names(loops) -> Set[str]:
    """Names rebound somewhere inside the given loop statements: the loop
    targets themselves plus every assignment in their bodies.  An argument
    built from one of these can change shape between iterations."""
    out: Set[str] = set()
    for loop in loops:
        if isinstance(loop, (ast.For, ast.AsyncFor)):
            out.update(fw.assigned_names(loop.target))
        for node in ast.walk(loop):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    out.update(fw.assigned_names(t))
            elif isinstance(node, (ast.AugAssign, ast.AnnAssign)):
                out.update(fw.assigned_names(node.target))
            elif isinstance(node, ast.withitem) and node.optional_vars:
                out.update(fw.assigned_names(node.optional_vars))
    return out


def _names_in(expr: ast.AST) -> Set[str]:
    return {n.id for n in ast.walk(expr) if isinstance(n, ast.Name)}


def _is_compiler(node: ast.AST) -> bool:
    """``torch.compile`` / ``torch.jit.script`` / ``torch.jit.trace`` (or
    the bare imported names)."""
    parts = fw.dotted_name(node).split(".")
    return ((parts[-1] == "compile" and "torch" in parts)
            or (parts[-1] in ("script", "trace") and "jit" in parts))


def _module_compiled(module: fw.Module) -> Set[str]:
    """Names bound in this file to a compiled callable: ``x =
    torch.compile(f)`` / ``torch.jit.script(f)`` bindings and defs decorated
    with ``@torch.compile``, ``@torch.compile(...)``, ``@torch.jit.script``
    or ``@partial(torch.compile, ...)``."""
    out: Set[str] = set()
    for node in ast.walk(module.tree):
        if isinstance(node, ast.Assign) and isinstance(node.value, ast.Call):
            if _is_compiler(node.value.func):
                out.update(fw.assigned_names(node.targets[0]))
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            for dec in node.decorator_list:
                target = dec.func if isinstance(dec, ast.Call) else dec
                if _is_compiler(target) or (
                        isinstance(dec, ast.Call)
                        and fw.dotted_name(dec.func).split(".")[-1]
                        == "partial"
                        and dec.args and _is_compiler(dec.args[0])):
                    out.add(node.name)
    return out


class RecompileHazardRule(fw.Rule):
    """TRK104: shape-disciplined API called in a loop without its
    shape-cache/shape-ladder keyword — or a locally compiled callable
    called in a loop with loop-varying arguments."""

    rule_id = "TRK104"
    summary = ("shape-keyed peel/pack API called inside a per-round loop "
               "without shape_cache=/shape_ladder= (launch shapes uncounted)")

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        findings: List[fw.Finding] = []
        apis = config.shape_disciplined_apis
        local_compiled = _module_compiled(module) - set(apis)
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            name = fw.call_name(node).split(".")[-1]
            required = apis.get(name)
            loops = fw.enclosing_loops(node)
            if not loops:
                continue
            if required is not None:
                kwargs = fw.keyword_names(node)
                if any(kw.arg is None for kw in node.keywords):
                    continue  # **kwargs forwarding: caller threads it
                if not any(r in kwargs for r in required):
                    findings.append(self.finding(
                        module, node,
                        f"`{name}` called inside a loop without "
                        f"{' / '.join(f'`{r}=`' for r in required)}: each "
                        f"data-dependent operand shape is a new launch "
                        f"shape that the run's `compiles` counter never "
                        f"sees — thread the run's shape cache through "
                        f"this call"))
            elif name in local_compiled:
                varying = _loop_varying_names(loops)
                args = list(node.args) + [kw.value for kw in node.keywords]
                hot = sorted(set().union(*[_names_in(a) for a in args])
                             & varying) if args else []
                if hot:
                    findings.append(self.finding(
                        module, node,
                        f"locally compiled `{name}` called inside a loop "
                        f"with loop-varying argument(s) "
                        f"{', '.join(f'`{h}`' for h in hot)}: if their "
                        f"shapes differ between iterations every call "
                        f"re-specialises and recompiles — pad the operands "
                        f"to a fixed shape, hoist the call, or allowlist "
                        f"with the shape invariant as rationale"))
        return findings


class _DeviceTaint:
    """Which expressions of one function are device tensors."""

    def __init__(self, func: ast.AST, producers: Set[str], config):
        self.producers = producers
        self.sanctioned = set(config.sanctioned_syncs)
        self.dev_re = re.compile(config.device_arg_pattern)
        self.names: Set[str] = set()
        assigns = [n for n in ast.walk(func)
                   if isinstance(n, (ast.Assign, ast.AugAssign,
                                     ast.AnnAssign))
                   and n.value is not None]
        changed = True
        while changed:          # to a fixed point: b = a.sum() after a = ...
            changed = False
            for node in assigns:
                if not self.is_device(node.value):
                    continue
                targets = (node.targets if isinstance(node, ast.Assign)
                           else [node.target])
                for t in targets:
                    new = set(fw.assigned_names(t)) - self.names
                    if new:
                        self.names |= new
                        changed = True

    def _names_device(self, arg: ast.AST) -> bool:
        """Whether a `.to(...)` / `device=` argument names a device (not
        the host, not a dtype)."""
        if isinstance(arg, ast.Constant):
            return isinstance(arg.value, str) and arg.value != "cpu"
        if isinstance(arg, ast.Call):        # torch.device("cuda", i)
            return (fw.call_name(arg).split(".")[-1] == "device"
                    and not (arg.args and isinstance(arg.args[0],
                                                     ast.Constant)
                             and arg.args[0].value == "cpu"))
        name = fw.dotted_name(arg).split(".")[-1]
        return bool(name) and bool(self.dev_re.fullmatch(name))

    def _to_host(self, call: ast.Call) -> bool:
        """``x.to("cpu")`` / ``x.to(device="cpu")`` / ``x.to(torch.device(
        "cpu"))``."""
        args = list(call.args) + [kw.value for kw in call.keywords
                                  if kw.arg == "device"]
        for a in args:
            if isinstance(a, ast.Constant) and a.value == "cpu":
                return True
            if (isinstance(a, ast.Call)
                    and fw.call_name(a).split(".")[-1] == "device"
                    and a.args and isinstance(a.args[0], ast.Constant)
                    and a.args[0].value == "cpu"):
                return True
        return False

    def is_device(self, expr: ast.AST) -> bool:
        if isinstance(expr, ast.Name):
            return expr.id in self.names
        if isinstance(expr, ast.Call):
            return self._call_is_device(expr)
        if isinstance(expr, ast.BinOp):
            return self.is_device(expr.left) or self.is_device(expr.right)
        if isinstance(expr, ast.UnaryOp):
            return self.is_device(expr.operand)
        if isinstance(expr, ast.Compare):
            return any(self.is_device(e)
                       for e in [expr.left] + list(expr.comparators))
        if isinstance(expr, ast.BoolOp):
            return any(self.is_device(v) for v in expr.values)
        if isinstance(expr, ast.IfExp):
            return self.is_device(expr.body) or self.is_device(expr.orelse)
        if isinstance(expr, ast.Subscript):
            return self.is_device(expr.value)
        if isinstance(expr, ast.Attribute):
            return expr.attr in _DEVICE_ATTRS and self.is_device(expr.value)
        if isinstance(expr, ast.Starred):
            return self.is_device(expr.value)
        return False

    def _call_is_device(self, call: ast.Call) -> bool:
        name = fw.call_name(call)
        last = name.split(".")[-1]
        if last in self.sanctioned:
            return False
        if last in self.producers:
            return True
        if isinstance(call.func, ast.Attribute):
            recv = call.func.value
            if last == "cuda":
                return True
            if last == "to":
                if self._to_host(call):
                    return False
                if any(self._names_device(a) for a in call.args) or any(
                        kw.arg == "device" and self._names_device(kw.value)
                        for kw in call.keywords):
                    return True
                return self.is_device(recv)
            if self.is_device(recv):
                return last not in _SYNC_METHODS | _HOST_METHODS
        if name.startswith("torch."):
            for kw in call.keywords:
                if kw.arg == "device":
                    return self._names_device(kw.value)
            return any(self._holds_device(a) for a in call.args)
        return False

    def _holds_device(self, arg: ast.AST) -> bool:
        if isinstance(arg, (ast.List, ast.Tuple)):
            return any(self._holds_device(e) for e in arg.elts)
        if isinstance(arg, (ast.ListComp, ast.GeneratorExp)):
            return self.is_device(arg.elt)
        return self.is_device(arg)

    def synced(self, node: ast.AST) -> str:
        """The source of the device value ``node`` syncs on ('' when it is
        not a host sync on a device value)."""
        if isinstance(node, ast.Call):
            name = fw.call_name(node)
            last = name.split(".")[-1]
            if isinstance(node.func, ast.Attribute):
                recv = node.func.value
                if last in _SYNC_METHODS and self.is_device(recv):
                    return ast.unparse(recv)
                if (last == "to" and self._to_host(node)
                        and self.is_device(recv)):
                    return ast.unparse(recv)
            if name in _SYNC_BUILTINS and node.args and self.is_device(
                    node.args[0]):
                return ast.unparse(node.args[0])
            if (last in ("asarray", "array") and node.args
                    and name.split(".")[0] in ("np", "numpy")
                    and self.is_device(node.args[0])):
                return ast.unparse(node.args[0])
            return ""
        if isinstance(node, (ast.If, ast.While, ast.IfExp)):
            if self.is_device(node.test):
                return ast.unparse(node.test)
        return ""


class HostSyncRule(fw.Rule):
    """TRK105: host sync on a device tensor inside a hot round loop."""

    rule_id = "TRK105"
    summary = (".item()/.tolist()/.cpu()/int()/np.asarray or a branch on a "
               "device tensor inside a hot round loop (waits for the card)")

    def check(self, module: fw.Module, config) -> List[fw.Finding]:
        norm = module.path.replace("\\", "/")
        if not any(norm.endswith(suffix) for suffix in config.hot_modules):
            return []
        producers = set(config.device_producers) | _module_compiled(module)
        findings: List[fw.Finding] = []
        seen: Set[int] = set()
        for func in ast.walk(module.tree):
            if not isinstance(func, (ast.FunctionDef, ast.AsyncFunctionDef)):
                continue
            taint = _DeviceTaint(func, producers, config)
            for node in ast.walk(func):
                if id(node) in seen:
                    continue     # a nested def's node, already judged
                what = taint.synced(node)
                if not what:
                    continue
                loop_node = node.test if isinstance(
                    node, (ast.If, ast.While, ast.IfExp)) else node
                if not fw.enclosing_loops(loop_node):
                    continue
                seen.add(id(node))
                findings.append(self.finding(
                    module, node,
                    f"host sync on device tensor `{what}` inside a round "
                    f"loop: this waits until the card catches up and "
                    f"empties the launch queue — keep the value on the "
                    f"card, read it once outside the loop, or read it "
                    f"through `host_read` / `host_array` so "
                    f"`device.SYNCS` counts it"))
        return findings
