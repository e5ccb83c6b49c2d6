"""A whole run at a tiny size on the CPU, past the harness's look for a
card, with the timed path sound and then broken underneath: ``correct``
has to come out true, then false for each fault these cells can have.
The cells run on one card, so there is no exchange between chips to leave
out."""

import dataclasses

import pytest
import torch

from bench import check, run, spec, traffic as tr, weights
from bench.tests.conftest import DECODE, MIXED, PREFILL, SKEWED, tiny_config
from repro_torch.models import transformer as T

CELLS = {"dsmoe16b.prefill_2k": PREFILL, "phi35moe.prefill_2k": PREFILL,
         "dsmoe16b.decode_b160": DECODE}
SEED = 2 ** 31 + 11


def tiny_cell(name):
    """The cell's own limits and metrics on a tiny bf16 configuration of
    its family, at a tiny traffic of its kind."""
    real = spec.load_cell(name)
    family = "phi" if name.startswith("phi") else "dsmoe"
    settings = dict(real.settings, check_batches=3, trace_batches=1)
    return spec.Cell(name, tiny_config(family, "bfloat16"), CELLS[name],
                     settings, real.end_to_end, real.per_layer)


def roll_logits(fn):
    """A token altered where it is produced: the logits shifted by one
    along the vocabulary, so each argmax moves to another token."""
    def wrapped(*args, **kwargs):
        state, logits = fn(*args, **kwargs)
        return state, logits.roll(1, dims=-1)
    return wrapped


def state_unchanged(fn):
    """A decode step that returns its state unchanged."""
    def wrapped(params, cache, tokens, cfg, **kwargs):
        _, logits = fn(params, cache, tokens, cfg, **kwargs)
        return cache, logits
    return wrapped


def half_batch(fn):
    """Half of the batch left out: the first half's results stand in for
    the rest."""
    def wrapped(params, tokens, cfg, **kwargs):
        h = tokens.shape[0] // 2
        cache, logits = fn(params, tokens[:h], cfg, **kwargs)
        both = {k: torch.cat([v, v]) for k, v in cache.items()}
        return both, torch.cat([logits, logits])
    return wrapped


FAULTS = [("dsmoe16b.prefill_2k", "prefill", roll_logits),
          ("phi35moe.prefill_2k", "prefill", roll_logits),
          ("dsmoe16b.prefill_2k", "prefill", half_batch),
          ("dsmoe16b.decode_b160", "decode_step", roll_logits),
          ("dsmoe16b.decode_b160", "decode_step", state_unchanged),
          ("dsmoe16b.decode_b160", "prefill", half_batch)]


@pytest.mark.parametrize("name", list(CELLS))
@pytest.mark.parametrize("traced", [False, True])
def test_sound_run_is_correct(name, traced, cpu):
    res = run.run_cell(tiny_cell(name), SEED, 0.2, traced, cpu)
    assert res["correct"], res["checks"]
    assert res["failed"] == 0 and res["attempted"] > 0
    assert list(res)[-1] == "checks"
    want = {m["name"] for m in (tiny_cell(name).per_layer if traced
                                else tiny_cell(name).end_to_end)}
    assert set(res["metrics"]) <= want and res["metrics"]


@pytest.mark.parametrize("traffic", [MIXED, SKEWED],
                         ids=["mixed_lengths", "zipf_ids"])
def test_sound_run_on_other_mixes_is_correct(traffic, cpu):
    """Mixes that only data files define: prompt lengths that change from
    batch to batch (warmed, served and checked each at its own length),
    and skewed ids."""
    cell = tiny_cell("dsmoe16b.decode_b160")
    cell = dataclasses.replace(cell, traffic=traffic,
                               settings=dict(cell.settings, trace_batches=2))
    res = run.run_cell(cell, SEED, 0.01, True, cpu)
    assert res["correct"], res["checks"]
    assert res["checks"]["batches_checked"]["value"] == 3


@pytest.mark.parametrize("name,where,fault", FAULTS,
                         ids=[f"{n}-{w}-{f.__name__}" for n, w, f in FAULTS])
def test_broken_path_is_not_correct(name, where, fault, cpu, monkeypatch):
    monkeypatch.setattr(T, where, fault(getattr(T, where)))
    res = run.run_cell(tiny_cell(name), SEED, 0.2, False, cpu)
    assert not res["correct"], res["checks"]


def test_control_reads_above_the_program(cpu):
    """The control at a tiny size: the reference in fp8 in the program's
    place reads a mean gap over three times the program's, seed by seed
    (the chip's readings at the cells' sizes set the limits)."""
    conf = tiny_config("dsmoe", "bfloat16", layers=4)
    port, cfg = conf["port"], spec.lm_config(conf)
    for traffic in (PREFILL, DECODE):
        for seed in (1, 2, 3):
            params = weights.make_params(port, seed, cpu)
            got = [check.readings(params, port, traffic, seed, b.index,
                                  b.served, cpu, b.logits, control=True)
                   for b in (run.serve_batch(params, cfg, traffic,
                                             port["vocab"], seed, i, cpu)
                             for i in range(4))]
            for key in ("gap", "err"):
                prog = torch.cat([g[key] for g in got]).mean()
                ctl = torch.cat([g[f"{key}_control"] for g in got]).mean()
                assert ctl > 3 * prog and ctl > 0.05, (key, seed, prog, ctl)


@pytest.mark.parametrize("name", list(CELLS))
def test_control_is_not_correct_by_the_cells_limits(name, cpu):
    """The control put in the program's place and judged as a run is, by
    the cell's own limits: not correct, where the program is correct.  A
    tiny model of 12 layers, three seeds' batches pooled (the chip's
    control, ``control.py``, reads at the cell's sizes)."""
    real = spec.load_cell(name)
    family = "phi" if name.startswith("phi") else "dsmoe"
    conf = tiny_config(family, "bfloat16", layers=12)
    port, cfg = conf["port"], spec.lm_config(conf)
    got = []
    for seed in (1, 2, 3):
        params = weights.make_params(port, seed, cpu)
        got += [check.readings(params, port, CELLS[name], seed, b.index,
                               b.served, cpu, b.logits, control=True)
                for b in (run.serve_batch(params, cfg, CELLS[name],
                                          port["vocab"], seed, i, cpu)
                          for i in range(6))]
    limits = real.settings["limits"]
    ok, checks = check.judge(got, 0, limits)
    assert ok, checks
    ctl_ok, ctl_checks = check.judge([check.control_view(g) for g in got], 0,
                                     limits)
    assert not ctl_ok, ctl_checks


def test_judge():
    limits = {"gap_mean": 0.1, "logit_err_median": 0.05}
    one = {"gap": torch.tensor([0.0, 0.3]), "err": torch.tensor([0.01, 0.02,
                                                                 0.9])}
    ok, checks = check.judge([one], 0, limits)
    assert not ok and checks["gap_mean"]["value"] == pytest.approx(0.15)
    assert checks["logit_err_median"]["value"] == pytest.approx(0.02)
    ok, checks = check.judge([one], 0, {"logit_err_median": 0.05})
    assert ok and list(checks) == ["logit_err_median", "failed",
                                   "batches_checked"]
    ok, checks = check.judge([one], 8, {"logit_err_median": 0.05})
    assert not ok and checks["failed"]["value"] == 8
    ok, _ = check.judge([], 0, limits)
    assert not ok
    assert tr.WARMUP > 10 ** 6
