"""The port's examples (``examples/*_torch.py``) against the reference's.

``quickstart_torch`` and ``truss_analysis_torch`` on the CPU print exactly
the reference examples' lines (``truss_analysis``'s are also the constants
``chip_smoke.py`` phase 15 holds the card's run to, and the reference's own
run is held to them here).  ``train_gnn_truss_torch`` gives finite losses
that fall (its parameters come from a torch generator, so its losses are
not the reference's).  ``serve_lm_torch`` and ``train_lm_torch`` hand the
port's launchers the reference examples' argv plus ``--device`` (captured
from each launcher's ``main``), and run end to end on the CPU.
"""

import importlib.util
import json
import math
import os
import runpy
import sys
import tempfile
from pathlib import Path

import pytest

import chip_smoke

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"


def _load(name):
    spec = importlib.util.spec_from_file_location(name, EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _lines(capsys, fn):
    capsys.readouterr()
    fn()
    return capsys.readouterr().out.splitlines()


def test_quickstart_prints_the_reference_lines(capsys):
    want = _lines(capsys, _load("quickstart").main)
    got = _lines(capsys, lambda: _load("quickstart_torch").main(device="cpu"))
    assert got == want
    assert got[1].startswith("  Phi_2: (i,k)") and "agree" in got[-1]


@pytest.mark.parametrize("example", ["truss_analysis", "truss_analysis_torch"])
def test_truss_analysis_prints_the_smoke_constants(capsys, example):
    kw = {"device": "cpu"} if example.endswith("_torch") else {}
    got = _lines(capsys, lambda: _load(example).main(**kw))
    assert got == list(chip_smoke.TRUSS_ANALYSIS_LINES)


def test_train_gnn_truss_losses_finite(capsys):
    mod = _load("train_gnn_truss_torch")
    for weighted in (False, True):
        loss = mod.run(weighted, steps=3, device="cpu")
        assert isinstance(loss, float) and math.isfinite(loss)
    line = _lines(capsys, lambda: mod.main(device="cpu"))
    assert len(line) == 1 and line[0].startswith(
        "GraphSAGE final loss — uniform sampling: ")


@pytest.mark.parametrize("weighted", [False, True])
def test_train_gnn_truss_losses_fall(weighted):
    losses = _load("train_gnn_truss_torch").train(weighted, 60, device="cpu")
    assert len(losses) == 60 and all(math.isfinite(x) for x in losses)
    assert sum(losses[-10:]) < 0.75 * sum(losses[:10])


def _ref_argv(monkeypatch, example, launcher, argv):
    """The argv the reference example hands its launcher's ``main``."""
    seen = []
    monkeypatch.setattr(launcher, "main", lambda: seen.append(list(sys.argv)))
    monkeypatch.setattr(sys, "argv", [str(EXAMPLES / example)] + argv)
    runpy.run_path(str(EXAMPLES / example), run_name="__main__")
    return seen[0][1:]


def test_serve_lm_hands_the_reference_argv(monkeypatch):
    from repro.launch import serve as jserve
    from repro_torch.launch import serve as tserve

    want = _ref_argv(monkeypatch, "serve_lm.py", jserve, [])
    seen = []
    monkeypatch.setattr(tserve, "main", seen.append)
    mod = _load("serve_lm_torch")
    mod.main(["--device", "cpu"])
    mod.main([])
    assert seen == [want + ["--device", "cpu"], want + ["--device", "cuda"]]
    assert want == ["--arch", "gemma3-4b", "--requests", "8", "--prompt-len",
                    "32", "--new-tokens", "16"]


@pytest.mark.parametrize("steps", [None, "20"])
def test_train_lm_hands_the_reference_argv(monkeypatch, steps):
    from repro.launch import train as jtrain
    from repro_torch.launch import train as ttrain

    extra = [] if steps is None else ["--steps", steps]
    want = _ref_argv(monkeypatch, "train_lm.py", jtrain, extra)
    seen = []
    monkeypatch.setattr(ttrain, "main", seen.append)
    _load("train_lm_torch").main(extra + ["--device", "cpu"])
    i = want.index("--ckpt-dir") + 1
    want[i] = os.path.join(tempfile.gettempdir(), "repro_torch_example_lm")
    assert seen == [want + ["--device", "cpu"]]
    assert want[want.index("--steps") + 1] == (steps or "200")


def test_serve_and_train_lm_run_on_the_host(capsys, tmp_path):
    out = _lines(capsys, lambda: _load("serve_lm_torch").main(
        ["--device", "cpu"]))
    assert out[0].startswith("[serve] gemma3-4b on cpu: 8 requests, prefill "
                             "32 toks")
    assert out[1].startswith("[serve] first request generation: [")
    assert len(json.loads(out[1].split(": ", 1)[1])) == 16
    out = _lines(capsys, lambda: _load("train_lm_torch").main(
        ["--steps", "3", "--ckpt-dir", str(tmp_path), "--device", "cpu"]))
    assert out[0].startswith("[train] qwen2.5-14b: ")
    assert any("loss" in x and "over 3 steps" in x for x in out)
