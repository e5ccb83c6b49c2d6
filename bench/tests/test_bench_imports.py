"""The harness loads nothing of JAX or of the JAX package, the reference
nothing of the program, and a run without a card prints no result."""

import ast
import json
import shutil
import subprocess
import sys
from pathlib import Path

from bench import run, spec

ROOT = spec.ROOT
BENCH = ROOT / "bench"


def _imports(path: Path) -> set:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_no_source_imports_jax_or_the_jax_package():
    for path in BENCH.rglob("*.py"):
        assert not _imports(path) & {"jax", "jaxlib", "flax", "repro"}, path


def test_reference_imports_nothing_of_the_program():
    for path in (BENCH / "reference").glob("*.py"):
        assert "repro_torch" not in _imports(path), path
        assert not _imports(path) - {"__future__", "math", "torch"}, path


def test_loaded_modules_after_the_harness_imports():
    """In a child process: run.py's imports, every metric reader, the
    trace reader and the program's serving path, then the top-level names
    of sys.modules, compared whole."""
    names = [m["name"] for m in spec.load_benchmark()["per_layer"]
             + spec.load_benchmark()["end_to_end"]]
    code = (
        "import importlib.util, json, sys\n"
        f"sys.path.insert(0, {str(BENCH)!r})\n"
        "import run\n"
        "from bench import spec, trace, check, control\n"
        "import repro_torch.launch.serve, repro_torch.models.transformer\n"
        f"[spec.metric_reader(n) for n in {names!r}]\n"
        "print(json.dumps(run.forbidden_modules()))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, cwd=ROOT, timeout=300)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.splitlines()[-1]) == []


def test_forbidden_names_are_compared_whole():
    ok = ["repro_torch.models", "jaxtyping", "flaxen", "torch"]
    assert run.forbidden_modules(ok) == []
    assert run.forbidden_modules(ok + ["repro.core", "jax.numpy"]) == [
        "jax", "repro"]


def test_no_card_no_result(capsys):
    rc = run.main(["--workload", "dsmoe16b.prefill_2k", "--seed", "1",
                   "--seconds", "1"])
    out = capsys.readouterr()
    assert rc != 0 and out.out == ""
    assert "CUDA" in out.err


def test_bare_benchmark_directory_gives_no_result(tmp_path):
    """A directory with only BENCHMARK.json and bench/ has no program."""
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(BENCH, tmp_path / "bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    out = subprocess.run([sys.executable, "bench/run.py", "--workload",
                          "dsmoe16b.prefill_2k", "--seed", "3", "--seconds",
                          "1", "--trace", "0"], capture_output=True, text=True,
                         cwd=tmp_path, timeout=300,
                         env={"PATH": "/usr/bin:/bin", "HOME": str(tmp_path)})
    assert out.returncode != 0 and out.stdout.strip() == ""
