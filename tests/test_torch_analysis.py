"""The port's trusscheck pass (``repro_torch.analysis``) against the
reference's (``repro.analysis``; stdlib only, so neither needs jax or a
card).

* The rules whose meaning did not change (TRK100 pragma hygiene, TRK102
  falsy-zero guards, TRK103 bare asserts) give the reference's findings,
  ``(rule_id, severity, line, col, allowlisted)``, on the same snippets:
  the reference's under a tmp ``src/repro/...`` tree, the port's under
  ``src/repro_torch/...``.  ``--fix`` rewrites them to the same bytes; the
  CLI keeps the exit codes and the JSON keys.
* The re-aimed rules (TRK101, TRK104-TRK107) are held by golden positive
  and negative fixtures in the port's idiom, and the repairs the sweep
  made in ``src/repro_torch`` are held by putting each site back as it was
  in a copy and seeing the rule flag it.
* The self-run: ``src/repro_torch`` checks clean, its allowlists pinned.
* Each kernel binding's plain-Python shared-memory estimate reproduces the
  C formula of its ``csrc/<name>.cu`` (constants and bodies read from the
  source) at the shapes the main paths give it, within the card's budget.
"""

import ast
import json
import re
import subprocess
import sys
import textwrap
from pathlib import Path

import pytest

from repro import analysis as ref_analysis
from repro.analysis.fixes import apply_fixes as ref_apply_fixes
from repro_torch import analysis
from repro_torch.analysis import framework as fw
from repro_torch.analysis.fixes import apply_fixes

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"
CSRC = PORT / "csrc"


def _write(root, source, rel):
    f = root / rel
    f.parent.mkdir(parents=True, exist_ok=True)
    f.write_text(textwrap.dedent(source), encoding="utf-8")
    return f


def _check(tmp_path, source, *, rel="src/repro_torch/mod.py", only=None):
    f = _write(tmp_path, source, rel)
    return f, analysis.check_paths([str(f)], only=only)


def _ids(report):
    return sorted(f.rule_id for f in report.active)


def _keys(report):
    return [(f.rule_id, f.severity, f.line, f.col, f.allowlisted)
            for f in report.findings]


# ---------------------------------------------------------------------------
# parity with the reference: TRK100, TRK102, TRK103
# ---------------------------------------------------------------------------

PARITY = {
    "budget_fallback": """
        def truss_decompose(g, memory_budget=None):
            if memory_budget:   # BUG: 0 silently routed to the default
                return "out-of-core"
            return "in-memory"
    """,
    "budget_fallback_fixed": """
        def truss_decompose(g, memory_budget=None):
            if memory_budget is not None and memory_budget <= 0:
                raise ValueError(f"memory_budget must be positive, got "
                                 f"{memory_budget!r}")
            if memory_budget is not None:
                return "out-of-core"
            return "in-memory"
    """,
    "or_default_and_annotation": """
        def pack(lane_capacity=None, depth: int | None = None):
            cap = lane_capacity or 1
            d = depth or 4
            while not lane_capacity:
                break
            return cap + d if depth else cap
    """,
    "non_numeric_names": """
        def load(path=None, verbose=False):
            if path:
                return path
            if verbose:
                print("default")
            return "default"
    """,
    "bare_assert": """
        def restore(blob):
            assert blob["magic"] == 7, "corrupt snapshot"   # erased by -O
            return blob["state"]
    """,
    "typed_raise": """
        def restore(blob):
            if blob["magic"] != 7:
                raise ValueError("corrupt snapshot")
            return blob["state"]
    """,
    "pragma_with_rationale": """
        def restore(blob):
            assert blob  # trusscheck: allow[TRK103] -- test-only scaffold
            return blob
    """,
    "pragma_on_line_above": """
        def restore(blob):
            # trusscheck: allow[TRK103] -- test-only scaffold
            assert blob
            return blob
    """,
    "pragma_without_rationale": """
        def restore(blob):
            assert blob  # trusscheck: allow[TRK103]
            return blob
    """,
    "stale_pragma": """
        def restore(blob):
            # trusscheck: allow[TRK103] -- nothing here anymore
            return blob
    """,
    "multi_id_pragma_and_multiline": """
        def restore(blob, budget=None):
            if budget: assert blob  # trusscheck: allow[TRK102,TRK103] -- ok
            assert (blob["magic"]
                    == 7)
            return blob
    """,
}


@pytest.mark.parametrize("only", [["TRK102", "TRK103"], None],
                         ids=["guards", "all_rules"])
@pytest.mark.parametrize("name", sorted(PARITY))
def test_guard_findings_equal_the_reference(tmp_path, name, only):
    src = PARITY[name]
    ref_f = _write(tmp_path / "ref", src, "src/repro/mod.py")
    port_f = _write(tmp_path / "port", src, "src/repro_torch/mod.py")
    want = ref_analysis.check_paths([str(ref_f)], only=only)
    got = analysis.check_paths([str(port_f)], only=only)
    assert _keys(got) == _keys(want)
    if name in ("budget_fallback", "bare_assert",
                "pragma_without_rationale", "stale_pragma",
                "or_default_and_annotation"):
        assert got.errors                  # the fixture does flag


@pytest.mark.parametrize("name", ["bare_assert", "budget_fallback"])
def test_guards_scoped_like_the_reference(tmp_path, name):
    # outside the library roots (tests, scripts) TRK103 is silent in both
    src = PARITY[name]
    ref_f = _write(tmp_path / "ref", src, "scratch/helper.py")
    port_f = _write(tmp_path / "port", src, "scratch/helper.py")
    assert _keys(analysis.check_paths([str(port_f)])) == _keys(
        ref_analysis.check_paths([str(ref_f)]))


FIXES = {
    "assert": ("""
        def restore(blob):
            assert blob["magic"] == 7, "corrupt snapshot"
            assert blob
            return blob["state"]
    """, ["TRK103"], 2),
    "falsy_guard_and_or_default": ("""
        def pack(lane_capacity=None):
            if lane_capacity:
                cap = lane_capacity
            if not lane_capacity:
                cap = 1
            cap = lane_capacity or 64
            return cap
    """, ["TRK102"], 3),
    "allowlisted_and_multiline": ("""
        def restore(blob):
            assert blob  # trusscheck: allow[TRK103] -- scaffold
            assert (blob["magic"]
                    == 7)
            return blob
    """, ["TRK103"], 0),
}


@pytest.mark.parametrize("name", sorted(FIXES))
def test_fix_rewrites_byte_identical_to_the_reference(tmp_path, name):
    src, only, n = FIXES[name]
    ref_f = _write(tmp_path / "ref", src, "src/repro/mod.py")
    port_f = _write(tmp_path / "port", src, "src/repro_torch/mod.py")
    n_ref = ref_apply_fixes(
        str(ref_f), ref_analysis.check_paths([str(ref_f)],
                                             only=only).findings)
    n_port = apply_fixes(
        str(port_f), analysis.check_paths([str(port_f)],
                                          only=only).findings)
    assert n_port == n_ref == n
    assert port_f.read_bytes() == ref_f.read_bytes()
    ast.parse(port_f.read_text(encoding="utf-8"))
    if n:
        assert _ids(analysis.check_paths([str(port_f)], only=only)) == []


def test_fix_keeps_the_fixed_behaviour(tmp_path):
    f, report = _check(tmp_path, FIXES["falsy_guard_and_or_default"][0],
                       only=["TRK102"])
    assert apply_fixes(str(f), report.findings) == 3
    ns = {}
    exec(compile(f.read_text(encoding="utf-8"), str(f), "exec"), ns)
    assert ns["pack"](0) == 0          # 0 no longer falls back to 64
    assert ns["pack"](None) == 64
    assert ns["pack"](8) == 8


# ---------------------------------------------------------------------------
# CLI: exit codes and the JSON report
# ---------------------------------------------------------------------------

def _cli(module, *args):
    return subprocess.run(
        [sys.executable, "-m", module, *args], capture_output=True,
        text=True, cwd=REPO, timeout=120,
        env={"PYTHONPATH": str(REPO / "src"), "PATH": "/usr/bin:/bin"})


def _json_block(stdout):
    lines = stdout.splitlines()
    return json.loads("\n".join(lines[lines.index("{"):lines.index("}") + 1]))


@pytest.mark.parametrize("case", ["dirty", "clean", "unknown_rule",
                                  "list_rules"])
def test_cli_exit_codes_and_json_match_the_reference(tmp_path, case):
    dirty = PARITY["bare_assert"]
    if case == "list_rules":
        got = _cli("repro_torch.analysis", "--list-rules")
        assert got.returncode == 0
        ids = [line.split()[0] for line in got.stdout.splitlines()]
        assert ids == [f"TRK10{i}" for i in range(1, 8)]
        return
    src = {"dirty": dirty, "clean": "X = 1\n", "unknown_rule": dirty}[case]
    ref_f = _write(tmp_path / "ref", src, "src/repro/mod.py")
    port_f = _write(tmp_path / "port", src, "src/repro_torch/mod.py")
    extra = ["--rules", "TRK999"] if case == "unknown_rule" else []
    want = _cli("repro.analysis", str(ref_f), "--json", "-", *extra)
    got = _cli("repro_torch.analysis", str(port_f), "--json", "-", *extra)
    assert got.returncode == want.returncode == {"dirty": 1, "clean": 0,
                                                 "unknown_rule": 2}[case]
    if case == "unknown_rule":
        assert "TRK999" in got.stderr
        return
    jw, jg = _json_block(want.stdout), _json_block(got.stdout)
    assert sorted(jg) == sorted(jw)
    assert [sorted(f) for f in jg["findings"]] == [
        sorted(f) for f in jw["findings"]]
    assert (jg["active"], jg["errors"]) == (jw["active"], jw["errors"])
    assert got.stdout.splitlines()[-1].endswith(
        "clean" if case == "clean" else "FAILED")


def test_cli_defaults_to_the_port_and_writes_json(tmp_path):
    out = tmp_path / "report.json"
    got = _cli("repro_torch.analysis", "--json", str(out),
               "--show-allowlisted")
    assert got.returncode == 0, got.stdout
    report = json.loads(out.read_text())
    assert report["errors"] == 0
    assert report["files_checked"] == len(
        [p for p in PORT.rglob("*.py") if "__pycache__" not in p.parts])


def test_analysis_modules_import_only_the_stdlib():
    stdlib = set(sys.stdlib_module_names) | {"__future__"}
    files = sorted((PORT / "analysis").glob("*.py"))
    assert len(files) == 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root in stdlib or name.startswith(
                    "repro_torch.analysis"), (path.name, name)


def test_each_reference_module_has_its_counterpart():
    ref = {p.name for p in (REPO / "src" / "repro" / "analysis").glob("*.py")}
    port = {p.name for p in (PORT / "analysis").glob("*.py")}
    assert port == ref - {"rules_pallas.py"} | {"rules_kernels.py"}


# ---------------------------------------------------------------------------
# TRK101: consumed handles and write-through aliasing
# ---------------------------------------------------------------------------

TRK101_CASES = {
    # a finalize retried on the same handle: the second attempt takes a
    # consumed handle
    "retried_handle": ("""
        def finalize_with_retry(handle):
            for attempt in range(2):
                try:
                    return handle.result()
                except RuntimeError:
                    continue
            raise RuntimeError("gave up")
    """, ["TRK101"]),
    "handle_rebuilt_per_attempt": ("""
        def finalize_with_retry(dispatch):
            for attempt in range(2):
                try:
                    handle = dispatch()
                    return handle.result()
                except RuntimeError:
                    continue
            raise RuntimeError("gave up")
    """, []),
    "result_taken_twice": ("""
        def finish(pending):
            phi, st = pending.result()
            again = pending.result()
            return phi, again
    """, ["TRK101"]),
    "result_once_then_attributes": ("""
        def finish(pending):
            alive, removed = pending.result()
            return alive, removed, pending.new_compile
    """, []),
    "result_after_rebinding": ("""
        def finish(dispatch):
            h = dispatch(0)
            a = h.result()
            h = dispatch(1)
            return a, h.result()
    """, []),
    "rows_aliased_in_one_launch": ("""
        from repro_torch.kernels.frontier_peel import kernel as fk

        def step(sup, alive, rm, tris, n):
            return fk.fused_round_live(sup, alive, rm, tris, n, tris, n)
    """, ["TRK101"]),
    "rows_aliased_through_a_name": ("""
        from repro_torch.kernels.frontier_peel import kernel as fk

        def step(sup, alive, rm, tris, n, n_out):
            out = tris
            return fk.fused_round_live(sup, alive, rm, tris, n, out, n_out)
    """, ["TRK101"]),
    "rows_aliased_in_the_buffer_pair": ("""
        from repro_torch.kernels.frontier_peel import kernel as fk

        class Rows:
            def round(self, sup, alive, rm):
                return fk.fused_round_live(sup, alive, rm, self.tris[0],
                                           self.cnt[0], self.tris[0],
                                           self.cnt[1])
    """, ["TRK101"]),
    # the ping-pong pair of kernels/frontier_peel/ops.py: read one buffer,
    # write the other, swap
    "rows_ping_pong": ("""
        import torch
        from repro_torch.kernels.frontier_peel import kernel as fk

        class _Rows:
            def __init__(self, tris, n_rows):
                self.tris = [tris.contiguous(), torch.empty_like(tris)]
                self.cnt = [n_rows, torch.empty_like(n_rows)]
                self.first = True

            def round(self, sup, alive, rm):
                out = fk.fused_round_live(sup, alive, rm, self.tris[0],
                                          self.cnt[0], self.tris[1],
                                          self.cnt[1])
                if self.first:
                    self.first = False
                    self.tris[0] = torch.empty_like(self.tris[1])
                    self.cnt[0] = torch.empty_like(self.cnt[1])
                self.tris.reverse()
                self.cnt.reverse()
                return out
    """, []),
    "alias_cleared_by_rebinding": ("""
        import torch
        from repro_torch.kernels.frontier_peel import kernel as fk

        def step(sup, alive, rm, tris, n):
            out = tris
            out = torch.empty_like(tris)
            n_out = torch.empty_like(n)
            return fk.fused_round_live(sup, alive, rm, tris, n, out, n_out)
    """, []),
    "fresh_output_buffers": ("""
        import torch
        from repro_torch.kernels.frontier_peel import kernel as fk

        def step(sup, alive, rm, tris, n):
            return fk.fused_round_live(sup, alive, rm, tris, n,
                                       torch.empty_like(tris),
                                       torch.empty_like(n))
    """, []),
}


@pytest.mark.parametrize("name", sorted(TRK101_CASES))
def test_trk101_fixtures(tmp_path, name):
    src, want = TRK101_CASES[name]
    _, report = _check(tmp_path, src, only=["TRK101"])
    assert _ids(report) == want, [f.render() for f in report.findings]


# ---------------------------------------------------------------------------
# TRK104: the shape-cache discipline and locally compiled callables
# ---------------------------------------------------------------------------

TRK104_CASES = {
    "loop_dispatch_without_shape_cache": ("""
        def rounds(batches):
            for batch in batches:
                out = peel_classes_batched(batch)
            return out
    """, ["TRK104"]),
    "shape_cache_or_outside_loops": ("""
        def rounds(batches, cache):
            for batch in batches:
                out = peel_classes_batched(batch, shape_cache=cache)
            once = peel_classes_batched(batches[0])
            return out, once
    """, []),
    "pack_without_ladder": ("""
        def pack(g, parts_by_round):
            for parts in parts_by_round:
                b = build_partition_batch(g, parts)
            return b
    """, ["TRK104"]),
    "kwargs_forwarding": ("""
        def rounds(batches, **kw):
            for batch in batches:
                out = local_threshold_peel(batch, **kw)
            return out
    """, []),
    "compiled_binding_loop_varying": ("""
        import torch

        step = torch.compile(lambda x: x.sum())

        def drive(frontiers):
            total = 0
            for f in frontiers:
                total += step(f[f >= 0])
            return total
    """, ["TRK104"]),
    "compiled_decorator_loop_varying": ("""
        import torch

        @torch.compile(dynamic=False)
        def fold(acc, x):
            return acc + x

        def drive(chunks):
            acc = 0
            for c in chunks:
                acc = fold(acc, c)
            return acc
    """, ["TRK104"]),
    "scripted_def_loop_varying": ("""
        import torch

        @torch.jit.script
        def fold(acc, x):
            return acc + x

        def drive(chunks):
            acc = 0
            for c in chunks:
                acc = fold(acc, c)
            return acc
    """, ["TRK104"]),
    "compiled_loop_invariant": ("""
        import torch

        step = torch.compile(lambda x: x * 2)

        def drive(x0, n):
            for _ in range(n):
                y = step(x0)
            return y
    """, []),
    "plain_function_loop_varying": ("""
        def step(x):
            return x * 2

        def drive(xs):
            for x in xs:
                y = step(x)
            return y
    """, []),
}


@pytest.mark.parametrize("name", sorted(TRK104_CASES))
def test_trk104_fixtures(tmp_path, name):
    src, want = TRK104_CASES[name]
    _, report = _check(tmp_path, src, only=["TRK104"])
    assert _ids(report) == want, [f.render() for f in report.findings]


def test_trk104_allowlisted_with_shape_invariant(tmp_path):
    _, report = _check(tmp_path, """
        import torch

        step = torch.compile(lambda x: x * 2)

        def drive(x):
            for _ in range(3):
                # trusscheck: allow[TRK104] -- x is loop-carried, one shape
                x = step(x)
            return x
    """, only=["TRK104"])
    assert report.errors == []
    assert [f.rule_id for f in report.findings if f.allowlisted] == ["TRK104"]


# ---------------------------------------------------------------------------
# TRK105: host syncs in the hot round loops
# ---------------------------------------------------------------------------

HOT = "src/repro_torch/core/bottom_up.py"

PERPART = """
    import numpy as np
    from repro_torch.core.peel import peel_threshold
    from repro_torch.device import host_array, host_read

    def levels(remaining, h_ids, sup, tris, internal, phi, k, dev):
        while remaining.any():
            _, _, removed = peel_threshold(sup, tris, np.ones(len(sup), bool),
                                           internal, k - 2, device=dev)
            {read}
            phi[rm_glob] = k
            remaining[rm_glob] = False
            k += 1
        return phi
"""

TRK105_CASES = {
    # the per-part seed path's level loop as it was: the removed mask
    # copied to the host without a count
    "perpart_cpu_numpy": ("rm_glob = h_ids[removed.cpu().numpy()]",
                          ["TRK105"]),
    "perpart_to_cpu": ('rm_glob = h_ids[removed.to("cpu").numpy()]',
                       ["TRK105"]),
    "perpart_np_asarray": ("rm_glob = h_ids[np.asarray(removed)]",
                           ["TRK105"]),
    "perpart_tolist": ("rm_glob = h_ids[removed.nonzero().tolist()]",
                       ["TRK105"]),
    "perpart_item_of_a_reduction": (
        "rm_glob = h_ids[:int(removed.sum().item())]", ["TRK105"]),
    "perpart_int_of_a_tensor": ("rm_glob = h_ids[:int(removed.sum())]",
                                ["TRK105"]),
    # the same reads, counted through the device module
    "perpart_host_read": ("(n_rm,) = host_read(removed.sum()); "
                          "rm_glob = h_ids[:n_rm]", []),
    "perpart_host_array": ("rm_glob = h_ids[host_array(removed)]", []),
}


@pytest.mark.parametrize("name", sorted(TRK105_CASES))
def test_trk105_perpart_level_loop(tmp_path, name):
    read, want = TRK105_CASES[name]
    src = textwrap.dedent(PERPART).replace("{read}", read)
    _, report = _check(tmp_path, src, rel=HOT, only=["TRK105"])
    assert _ids(report) == want, [f.render() for f in report.findings]


TRK105_MORE = {
    "branch_on_a_device_tensor": ("""
        import torch

        def rounds(sup, thresh, dev):
            alive = torch.ones(len(sup), dtype=torch.bool, device=dev)
            while True:
                rm = alive & (sup <= thresh)
                if rm.any():
                    alive = alive & ~rm
                else:
                    break
            return alive
    """, ["TRK105"]),
    "while_test_on_an_upload": ("""
        from repro_torch.core.peel import _put

        def rounds(mask, dev):
            live = _put(mask, bool, dev)
            while live.any():
                live = live[1:]
            return live
    """, ["TRK105"]),
    "bool_of_a_kernel_result": ("""
        from repro_torch.kernels.frontier_peel import kernel as fk

        def rounds(sup, alive, rm, tris):
            for _ in range(3):
                sup, alive = fk.fused_round(sup, alive, rm, tris)
                if not bool(alive.any()):
                    break
            return sup
    """, ["TRK105"]),
    "moved_with_to_device": ("""
        def rounds(parts, dev):
            out = []
            for p in parts:
                t = p.to(dev)
                out.append(float(t.mean()))
            return out
    """, ["TRK105"]),
    "host_read_in_the_loop": ("""
        import torch
        from repro_torch.device import host_read

        def rounds(sup, thresh, dev):
            alive = torch.ones(len(sup), dtype=torch.bool, device=dev)
            while True:
                rm = alive & (sup <= thresh)
                any_rm, n = host_read(rm.any(), rm.sum())
                if not any_rm:
                    break
                alive = alive & ~rm
            return alive
    """, []),
    "host_numpy_tolist_in_a_hot_loop": ("""
        import numpy as np

        def levels(phi, classes):
            out = []
            for k in classes:
                ids = np.flatnonzero(phi == k).tolist()
                out.append(int(np.asarray(ids).sum()))
                if ids:
                    out.append(len(ids))
            return out
    """, []),
    "host_tensor_without_device": ("""
        import torch

        def levels(rows):
            out = []
            for r in rows:
                t = torch.as_tensor(r)
                out.append(t.sum().item())
            return out
    """, []),
    "sync_after_the_loop": ("""
        from repro_torch.kernels.frontier_peel import kernel as fk

        def rounds(sup, alive, rm, tris):
            for _ in range(3):
                sup, alive = fk.fused_round(sup, alive, rm, tris)
            return sup.cpu().numpy()
    """, []),
    "sync_in_a_closure_run_later": ("""
        from repro_torch.kernels.frontier_peel import kernel as fk

        def rounds(sup, alive, rm, tris, handles):
            for _ in range(3):
                phi = fk.fused_round(sup, alive, rm, tris)[0]
                handles.append(lambda: phi.cpu().numpy())
            return handles
    """, []),
}


@pytest.mark.parametrize("name", sorted(TRK105_MORE))
def test_trk105_fixtures(tmp_path, name):
    src, want = TRK105_MORE[name]
    _, report = _check(tmp_path, src, rel=HOT, only=["TRK105"])
    assert _ids(report) == want, [f.render() for f in report.findings]


def test_trk105_scoped_to_hot_modules(tmp_path):
    src = textwrap.dedent(PERPART).replace(
        "{read}", TRK105_CASES["perpart_cpu_numpy"][0])
    _, report = _check(tmp_path, src, rel="src/repro_torch/launch/bench.py",
                       only=["TRK105"])
    assert _ids(report) == []


# ---------------------------------------------------------------------------
# TRK106: fault-site coverage, hooks one call deep
# ---------------------------------------------------------------------------

PEEL = "src/repro_torch/core/peel.py"

TRK106_CASES = {
    "unregistered_site": ("""
        def risky(faults):
            faults.check("bogus-site", round=1)
    """, "src/repro_torch/mod.py", ["TRK106"]),
    "hook_missing": ("""
        def peel_classes_batched(batch):
            return batch
    """, PEEL, ["TRK106"]),
    # the port's dispatch: the hook sits in _check_dispatch, called
    # directly on the single-device path
    "hooked_through_check_dispatch": ("""
        from repro_torch.core import faults

        def _check_dispatch(fault_ctx):
            if fault_ctx is not None:
                faults.check(faults.DISPATCH, **fault_ctx)

        def peel_classes_batched(batch, fault_ctx=None, mesh=None):
            if mesh is None:
                _check_dispatch(fault_ctx)
            return batch
    """, PEEL, []),
    # and deferred as `before=` on the mesh path
    "hooked_through_a_deferred_lambda": ("""
        from repro_torch.core import faults

        def _check_dispatch(fault_ctx):
            if fault_ctx is not None:
                faults.check(faults.DISPATCH, **fault_ctx)

        def local_threshold_peel(sup, fault_ctx=None, mesh=None):
            return sharded(mesh, sup,
                           before=lambda: _check_dispatch(fault_ctx))
    """, PEEL, []),
    # a helper without the hook hooks nothing
    "helper_without_the_hook": ("""
        from repro_torch.core import faults

        def _check_dispatch(fault_ctx):
            return fault_ctx

        def peel_classes_batched(batch, fault_ctx=None):
            _check_dispatch(fault_ctx)
            return batch
    """, PEEL, ["TRK106"]),
    # a helper with the wrong site hooks nothing either
    "helper_with_another_site": ("""
        from repro_torch.core import faults

        def _check_finalize(fault_ctx):
            faults.check(faults.FINALIZE, **fault_ctx)

        def peel_classes_batched(batch, fault_ctx=None):
            _check_finalize(fault_ctx)
            return batch
    """, PEEL, ["TRK106"]),
    # one call deep only: a helper of a helper does not count
    "helper_two_calls_deep": ("""
        from repro_torch.core import faults

        def _hook(fault_ctx):
            faults.check(faults.DISPATCH, **fault_ctx)

        def _check_dispatch(fault_ctx):
            _hook(fault_ctx)

        def peel_classes_batched(batch, fault_ctx=None):
            _check_dispatch(fault_ctx)
            return batch
    """, PEEL, ["TRK106"]),
    "plain_names_do_not_bind_to_methods": ("""
        from repro_torch.core import faults

        def save(state):
            faults.check(faults.CHECKPOINT_WRITE, step=0)
            return state

        class AsyncWriter:
            def save(self, state):
                return save(state)
    """, "src/repro_torch/checkpoint/manager.py", []),
    "driver_dispatch_without_fault_ctx": ("""
        def rounds(batches):
            for b in batches:
                out = peel_classes_batched(b, shape_cache=None)
            return out
    """, "src/repro_torch/core/bottom_up.py", ["TRK106"]),
    "driver_dispatch_with_fault_ctx": ("""
        def rounds(batches):
            for b in batches:
                out = peel_classes_batched(
                    b, shape_cache=None,
                    fault_ctx={"stage": 1, "round": 0})
            return out
    """, "src/repro_torch/core/bottom_up.py", []),
}


@pytest.mark.parametrize("name", sorted(TRK106_CASES))
def test_trk106_fixtures(tmp_path, name):
    src, rel, want = TRK106_CASES[name]
    _, report = _check(tmp_path, src, rel=rel, only=["TRK106"])
    assert _ids(report) == want, [f.render() for f in report.findings]


def test_trk106_reads_the_ports_registry(tmp_path):
    _write(tmp_path, 'DISPATCH = "dispatch"\nCUSTOM = "custom-site"\n',
           "src/repro_torch/core/faults.py")
    _, report = _check(tmp_path, """
        def risky(faults):
            faults.check("custom-site", round=1)
            faults.check(faults.DISPATCH, round=2)
            faults.check(faults.MISSING, round=3)
    """, rel="src/repro_torch/core/top_down.py", only=["TRK106"])
    assert _ids(report) == ["TRK106"]
    assert "MISSING" in report.active[0].message


# ---------------------------------------------------------------------------
# TRK107: kernel bindings
# ---------------------------------------------------------------------------

BINDING = "src/repro_torch/kernels/toy/kernel.py"

KERNEL_FIXED = """
    import ctypes

    from repro_torch.kernels import build

    TILE = 128
    STAGES = 3

    def smem_bytes() -> int:
        return STAGES * 2 * TILE * TILE + 1024

    def launch(A):
        n = A.shape[0]
        n_pad = -(-n // TILE) * TILE
        if smem_bytes() > build.SMEM_BUDGET_BYTES:
            raise ValueError("over the shared-memory budget")
        lib = build.library("toy")
        rc = lib.toy(A.data_ptr(), n_pad, None)
        build.check(lib, rc, "toy")
"""

TRK107_CASES = {
    "ceil_div_pad_and_smem_compare": (KERNEL_FIXED, []),
    "ceil_div_by_sum_and_named_estimate": ("""
        from repro_torch.kernels import build

        BLOCK = 256

        def kernel_smem_bytes(d):
            return 4 * BLOCK * d

        def launch(x, d):
            need = kernel_smem_bytes(d)
            if need > build.SMEM_BUDGET_BYTES:
                raise ValueError("over budget")
            grid = (x.shape[0] + BLOCK - 1) // BLOCK
            lib = build.library("toy")
            build.check(lib, lib.toy(x.data_ptr(), grid), "toy")
    """, []),
    # a floor division guarded by a live % with a typed raise, reached one
    # call deep through a helper, as check_gqa guards hq // hkv
    "guarded_floor_div_in_a_helper": ("""
        from repro_torch.kernels import build

        def smem_bytes(d):
            return 4 * d

        def check_gqa(q, k):
            hq, hkv = q.shape[1], k.shape[1]
            if hq % hkv:
                raise ValueError("q heads must be a multiple of kv heads")
            return hq // hkv

        def launch(q, k):
            group = check_gqa(q, k)
            if smem_bytes(q.shape[3]) > build.SMEM_BUDGET_BYTES:
                raise ValueError("over budget")
            lib = build.library("toy")
            rc = lib.toy(q.data_ptr(), k.data_ptr(), group)
            build.check(lib, rc, "toy")
    """, []),
    # the guard is an assert: erased under -O, so no guard at all
    "assert_guard": ("""
        from repro_torch.kernels import build

        def smem_bytes(block):
            return 4 * block

        def launch(x, block: int = 128):
            assert x.shape[0] % block == 0
            if smem_bytes(block) > build.SMEM_BUDGET_BYTES:
                raise ValueError("over budget")
            lib = build.library("toy")
            rc = lib.toy(x.data_ptr(), x.shape[0] // block)
            build.check(lib, rc, "toy")
    """, ["TRK107"]),
    "tile_parameter_passed_unguarded": ("""
        from repro_torch.kernels import build

        def smem_bytes(block):
            return 4 * block

        def launch(x, block: int = 128):
            if smem_bytes(block) > build.SMEM_BUDGET_BYTES:
                raise ValueError("over budget")
            lib = build.library("toy")
            rc = lib.toy(x.data_ptr(), x.shape[0], block)
            build.check(lib, rc, "toy")
    """, ["TRK107"]),
    "no_estimate": (KERNEL_FIXED.replace(
        "        if smem_bytes() > build.SMEM_BUDGET_BYTES:\n"
        "            raise ValueError(\"over the shared-memory budget\")\n",
        "").replace("def smem_bytes", "def working_set"), ["TRK107"]),
    "estimate_never_compared": (KERNEL_FIXED.replace(
        "        if smem_bytes() > build.SMEM_BUDGET_BYTES:\n"
        "            raise ValueError(\"over the shared-memory budget\")\n",
        ""), ["TRK107"]),
    "estimate_compared_against_another_limit": (KERNEL_FIXED.replace(
        "build.SMEM_BUDGET_BYTES", "1 << 20"), ["TRK107"]),
    "both_missing": (KERNEL_FIXED.replace(
        "-(-n // TILE) * TILE", "n // TILE * TILE").replace(
        "smem_bytes() > build.SMEM_BUDGET_BYTES", "n > 0"),
        ["TRK107", "TRK107"]),
    # a module that loads no library through build.library is no binding
    "not_a_binding": ("""
        def launch(x, block: int = 128):
            return x.shape[0] // block
    """, []),
}


@pytest.mark.parametrize("name", sorted(TRK107_CASES))
def test_trk107_fixtures(tmp_path, name):
    src, want = TRK107_CASES[name]
    _, report = _check(tmp_path, src, rel=BINDING, only=["TRK107"])
    assert _ids(report) == want, [f.render() for f in report.findings]
    if name == "assert_guard":
        assert "`block`" in report.active[0].message
        _, all_rules = _check(tmp_path, src, rel=BINDING)
        assert "TRK103" in _ids(all_rules)


# ---------------------------------------------------------------------------
# the self-run, and the repairs the sweep made
# ---------------------------------------------------------------------------

# every allowlisted finding of the self-run, by (rule id, path under
# src/repro_torch); the sweep fixed every finding, so there is none
ALLOWLISTED: list = []


def test_self_run_port_is_clean():
    report = analysis.check_paths([str(PORT)])
    assert report.files_checked > 80
    assert [f.render() for f in report.errors] == []
    assert sorted((f.rule_id, Path(f.path).relative_to(PORT).as_posix())
                  for f in report.findings if f.allowlisted) == ALLOWLISTED
    for path in PORT.rglob("*.py"):
        for pragma in fw.parse_module(path).pragmas.values():
            assert pragma.rationale, (path, pragma.line)


def test_peel_dispatch_sites_are_hooked_not_allowlisted():
    report = analysis.check_paths([str(PORT / "core" / "peel.py")],
                                  only=["TRK106"])
    assert report.findings == []
    src = (PORT / "core" / "peel.py").read_text(encoding="utf-8")
    assert "allow[TRK106" not in src
    # and the hook those two sites reach is a real one: drop it from the
    # helper and both are flagged
    broken = src.replace("        faults.check(faults.DISPATCH, **fault_ctx)",
                         "        pass")
    assert broken != src
    report = _checked_copy(broken, "core/peel.py", ["TRK106"])
    names = sorted(re.search(r"`(\w+)`", f.message)[1]
                   for f in report.active)
    assert names == ["local_threshold_peel", "peel_classes_batched"]


def _checked_copy(source, rel, only):
    import tempfile
    with tempfile.TemporaryDirectory() as d:
        f = Path(d) / "src" / "repro_torch" / rel
        f.parent.mkdir(parents=True)
        f.write_text(source, encoding="utf-8")
        return analysis.check_paths([str(f)], only=only)


# each repair of the sweep, put back as it was: the rule flags it again
REPAIRS = {
    "perpart_counted_read": (
        "core/bottom_up.py", "TRK105",
        "rm_glob = h_ids[host_array(removed)]",
        "rm_glob = h_ids[removed.cpu().numpy()]"),
    "dryrun_single_result": (
        "launch/dryrun.py", "TRK101",
        'counted = counter.result()\n'
        '        coll = {"bytes": counted["collective_bytes"],\n'
        '                "counts": counted["collective_counts"]}',
        'coll = {"bytes": counter.result()["collective_bytes"],\n'
        '                "counts": counter.result()["collective_counts"]}'),
    "frontier_peel_smem_compare": (
        "kernels/frontier_peel/kernel.py", "TRK107",
        "if smem_bytes(E) > build.SMEM_BUDGET_BYTES:", "if False:"),
    "triangle_count_smem_compare": (
        "kernels/triangle_count/kernel.py", "TRK107",
        "if smem_bytes() > build.SMEM_BUDGET_BYTES:", "if False:"),
    "flash_attention_smem_compare": (
        "kernels/flash_attention/kernel.py", "TRK107",
        "if smem_bytes(d, q.dtype) > build.SMEM_BUDGET_BYTES:", "if False:"),
    "embedding_bag_smem_compare": (
        "kernels/embedding_bag/kernel.py", "TRK107",
        "if smem_bytes() > build.SMEM_BUDGET_BYTES:", "if False:"),
    "triangle_count_ceil_div": (
        "kernels/triangle_count/kernel.py", "TRK107",
        "n_pad = -(-n // TILE) * TILE", "n_pad = n // TILE * TILE"),
    "flash_attention_gqa_guard": (
        "kernels/flash_attention/kernel.py", "TRK107",
        "if hq % hkv:", "if hq < hkv:"),
    "decode_attention_smem_compare": (
        "kernels/decode_attention/kernel.py", "TRK107",
        "if smem_bytes(d, g, q.dtype) > build.SMEM_BUDGET_BYTES:",
        "if False:"),
    "decode_attention_gqa_guard": (
        "kernels/decode_attention/kernel.py", "TRK107",
        "if hq % hkv or hq // hkv > MAX_GROUP:",
        "if hq < hkv or hq // hkv > MAX_GROUP:"),
}


@pytest.mark.parametrize("name", sorted(REPAIRS))
def test_sweep_repairs_hold(name):
    rel, rule, now, before = REPAIRS[name]
    src = (PORT / rel).read_text(encoding="utf-8")
    assert now in src
    assert _checked_copy(src, rel, [rule]).errors == []
    report = _checked_copy(src.replace(now, before, 1), rel, [rule])
    assert [f.rule_id for f in report.errors] == [rule]


def test_host_array_counts_its_read():
    import torch

    from repro_torch import device

    s0 = device.SYNCS
    got = device.host_array(torch.tensor([True, False, True]))
    assert device.SYNCS == s0 + 1
    assert got.tolist() == [True, False, True]


# ---------------------------------------------------------------------------
# the shared-memory estimates against the C sources
# ---------------------------------------------------------------------------

def _c_to_py(expr: str) -> str:
    """A C integer expression of the kernels' sources as Python: casts and
    sizeof dropped or resolved, / as //, ?: as a conditional."""
    expr = re.sub(r"static_cast<\w+>\(([^()]*(?:\([^()]*\))?[^()]*)\)",
                  r"(\1)", expr)
    expr = re.sub(r"\((?:long long|int|unsigned|uint32_t)\)", "", expr)
    expr = re.sub(r"sizeof\((?:int32_t|int|float|uint32_t)\)", "4", expr)
    if "?" in expr:
        # right-associative a ? b : c ? d : e, no nesting in parentheses
        cond, rest = expr.split("?", 1)
        yes, no = rest.split(":", 1)
        return (f"(({_c_to_py(yes.strip())}) if ({_c_to_py(cond.strip())}) "
                f"else ({_c_to_py(no.strip())}))")
    return expr.replace("/", "//")


def _c_constants(src: str) -> dict:
    """The source's top-level integer constants (a template's, which
    depend on its parameters, are skipped)."""
    env: dict = {}
    for name, expr in re.findall(
            r"^constexpr (?:int|uint32_t) (\w+) = ([^;]+);", src, re.M):
        try:
            env[name] = eval(_c_to_py(expr), {}, dict(env))
        except NameError:
            continue
    return env


def _c_function(src: str, name: str, env: dict):
    """The C function ``name`` of one ``return`` (after local constants)
    as a Python callable over the source's constants."""
    m = re.search(rf"\b{name}\((?:int|void) ?(\w*)\) \{{(.*?)\n?\}}", src,
                  re.S)
    params, body = m[1], m[2]
    local = dict(env)
    code = ""
    for stmt in [s.strip() for s in body.split(";") if s.strip()]:
        stmt = " ".join(stmt.split())
        if stmt.startswith("return "):
            code = _c_to_py(stmt[len("return "):])
        else:
            lhs, rhs = stmt.split("=", 1)
            local[lhs.split()[-1]] = ("expr", _c_to_py(rhs.strip()))

    def call(*args):
        scope = dict(env)
        if params:
            scope[params] = args[0]
        for k, v in local.items():
            if isinstance(v, tuple):
                scope[k] = eval(v[1], {}, scope)
        for fn in ("tc_width", "tc_keys", "dynamic_smem_bytes",
                   "tc_smem_bytes", "smem_floats"):
            if fn in code and fn != name:
                scope[fn] = _c_function(src, fn, env)
        return eval(code, {}, scope)
    return call


B1_PATH_E = (1, 31, 32, 33, 25_408, 232_078, 314_000, 819_200, 819_201,
             1_048_576)


@pytest.mark.parametrize("E", B1_PATH_E)
def test_frontier_peel_smem_estimate_matches_the_source(E):
    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_peel import kernel as fk

    src = (CSRC / "frontier_peel.cu").read_text()
    env = _c_constants(src)
    assert fk.MAX_SMEM_BYTES == env["kMaxSmemBytes"]
    assert fk.STATIC_SMEM_BYTES == env["kStaticSmemBytes"]
    c = _c_function(src, "frontier_peel_smem_bytes", env)
    assert fk.smem_bytes(E) == c(E)
    assert fk.smem_bytes(E) <= build.SMEM_BUDGET_BYTES


@pytest.mark.parametrize("name", ["triangle_count", "embedding_bag"])
def test_fixed_smem_estimates_match_the_source(name):
    from repro_torch.kernels import build
    from repro_torch.kernels.embedding_bag import kernel as bk
    from repro_torch.kernels.triangle_count import kernel as tk

    mod = {"triangle_count": tk, "embedding_bag": bk}[name]
    src = (CSRC / f"{name}.cu").read_text()
    env = _c_constants(src)
    want = _c_function(src, f"{name}_smem_bytes", env)()
    assert mod.smem_bytes() == want <= build.SMEM_BUDGET_BYTES
    if name == "triangle_count":
        assert (tk.TILE, tk.STAGES) == (env["kTile"], env["kStages"])
        assert env["kSlab"] == tk.TILE
    else:
        assert (bk.WARPS, bk.STAGE) == (env["WARPS"], env["STAGE"])
        assert bk.STATIC_SMEM_BYTES == env["WARPS"] * env["STAGE"] * 4


@pytest.mark.parametrize("bf16", [False, True], ids=["float32", "bf16"])
@pytest.mark.parametrize("d", list(range(16, 257, 16)))
def test_flash_attention_smem_estimate_matches_the_source(d, bf16):
    import torch

    from repro_torch.kernels import build
    from repro_torch.kernels.flash_attention import kernel as ak

    src = (CSRC / "flash_attention.cu").read_text()
    env = _c_constants(src)
    assert (ak.F32_BQ, ak.F32_BK, ak.F32_P_STRIDE) == (
        env["kBQ"], env["kBK"], env["kPStride"])
    assert (ak.TC_ROWS, ak.TC_STAGES, ak.TC_BARRIER_BYTES) == (
        env["kRows"], env["kStages"], env["kBarrierBytes"])
    tc_keys = _c_function(src, "tc_keys", env)
    assert ak.TC_KEYS == {w: tc_keys(w) for w in (64, 128, 256)}
    # flash_attention_smem_bytes(d, bf16) returns the two routes' formulas
    assert re.search(r"return bf16 \? tc_smem_bytes\(tc_width\(d\)\)\s*"
                     r": smem_floats\(d\) \* \(int\)sizeof\(float\);", src)
    if bf16:
        width = _c_function(src, "tc_width", env)(d)
        want = _c_function(src, "tc_smem_bytes", env)(width)
        assert ak.tc_width(d) == width
    else:
        want = _c_function(src, "smem_floats", env)(d) * 4
    dtype = torch.bfloat16 if bf16 else torch.float32
    assert ak.smem_bytes(d, dtype) == want <= build.SMEM_BUDGET_BYTES


def test_smem_budget_is_the_h100_opt_in_limit():
    from repro_torch.kernels import build

    assert build.SMEM_BUDGET_BYTES == 227 * 1024
