"""The serving path's spans and MoE counters (``repro_torch.device.span``,
``traced``, ``count_kept``, ``read_counters``), on the CPU.

A tiny MoE ``LMConfig`` whose experts' capacity drops slots in both
phases is served through ``serve.generate`` with and without
``torch.profiler``: every span appears, at function scope (kineto's
``scope()`` 0, as aten ops; a user-scope range, as ``record_function``
makes, is mirrored onto the card's timeline), nested where it belongs; the
counters equal what ``moe_route`` decided, phase by phase, also under a
three-argument wrapper of ``_moe_ffn`` (``chip_smoke.RouteRecorder``);
without a profiler nothing is recorded; and the served bits are the same
either way."""

import chip_smoke
import numpy as np
import pytest
import torch

from repro_torch import device
from repro_torch.launch import serve
from repro_torch.models import transformer as T

CFG = T.LMConfig(n_layers=2, d_model=32, n_q=4, n_kv=2, d_head=8, vocab=64,
                 n_experts=4, top_k=2, d_ff_expert=16, n_shared_experts=1,
                 capacity_factor=0.5, param_dtype=torch.float32,
                 compute_dtype=torch.float32)
B, S, NEW = 3, 8, 4
MODEL = ("lm.attn", "lm.attn.core", "lm.moe.route", "lm.moe.dispatch",
         "lm.moe.experts", "lm.moe.combine", "lm.moe.shared", "lm.logits")
SPANS = MODEL + ("lm.prefill", "lm.decode_step", "serve.generate",
                 "serve.step", "serve.wait")


@pytest.fixture(scope="module")
def params():
    return T.init_params(torch.Generator().manual_seed(0), CFG)


def _prompts():
    return np.random.default_rng(0).integers(0, CFG.vocab, (B, S)).astype(
        np.int32)


def _serve(params):
    return serve.generate(params, _prompts(), CFG, NEW, S + NEW,
                          device="cpu")


def _profiled(params):
    device.reset_counters()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        gen = _serve(params)
    spans = [(e.name(), e.start_ns(), e.start_ns() + e.duration_ns(),
              e.scope()) for e in prof.profiler.kineto_results.events()
             if e.name() in SPANS]
    return gen, spans


def _inside(inner, outers):
    return any(s <= inner[1] and inner[2] <= e for _, s, e, _ in outers)


def test_spans_nest_at_function_scope(params):
    _, spans = _profiled(params)
    by = {n: [s for s in spans if s[0] == n] for n in SPANS}
    assert {s[3] for s in spans} == {0}
    calls = 1 + NEW                       # the prefill and each decode step
    assert len(by["lm.prefill"]) == 1 and len(by["lm.decode_step"]) == NEW
    assert len(by["serve.generate"]) == 1 and len(by["serve.step"]) == NEW
    assert len(by["serve.wait"]) == 2
    assert len(by["lm.logits"]) == calls
    for name in MODEL[:-1]:
        assert len(by[name]) == calls * CFG.n_layers, name
    model = by["lm.prefill"] + by["lm.decode_step"]
    for name in MODEL:
        assert all(_inside(s, model) for s in by[name]), name
    assert all(_inside(s, by["lm.attn"]) for s in by["lm.attn.core"])
    for name in MODEL[2:]:
        assert not any(_inside(s, by["lm.attn"]) for s in by[name]), name
    assert all(_inside(s, by["serve.step"]) for s in by["lm.decode_step"])
    assert all(_inside(s, by["serve.generate"]) for n in SPANS
               if n != "serve.generate" for s in by[n])
    assert not any(_inside(s, model) for s in by["serve.wait"])


def test_counters_equal_the_routing(params, monkeypatch):
    """Each ``moe_route`` call's kept slots, summed by phase (a prefill
    routes B*S tokens, a decode step B), against the counters; slots drop
    in both phases, and the slots routed are what the benchmark derives
    from the shapes (n_layers * tokens * top_k)."""
    seen = {"prefill": [0, 0], "decode": [0, 0]}
    route = T.moe_route

    def recording(xt, router, cfg):
        r = route(xt, router, cfg)
        got = seen["decode" if xt.shape[0] == B else "prefill"]
        got[0] += xt.shape[0] * cfg.top_k
        got[1] += int(r.keep.sum())
        return r

    monkeypatch.setattr(T, "moe_route", recording)
    s0 = device.SYNCS
    _profiled(params)
    assert device.SYNCS == s0 + 2          # generate's own two waits
    counters = device.read_counters()
    assert device.SYNCS == s0 + 3          # and one read of the counters
    assert counters == {phase: kept for phase, (_, kept) in seen.items()}
    for phase, (routed, kept) in seen.items():
        assert 0 < kept < routed, phase
    assert seen["prefill"][0] == CFG.n_layers * B * S * CFG.top_k
    assert seen["decode"][0] == CFG.n_layers * B * NEW * CFG.top_k
    # a second read needs no wait and reads the same
    assert device.read_counters() == counters and device.SYNCS == s0 + 3
    device.reset_counters()
    assert device.read_counters() == {}


def test_route_recorder_wraps_the_moe_ffn(params):
    """chip_smoke's ``RouteRecorder`` puts three-argument wrappers over
    ``moe_route`` and ``_moe_ffn``: served under the profiler, the tokens
    are those of the plain serve, every call is recorded, and the slots
    kept still count by phase."""
    plain = _serve(params)
    rec = chip_smoke.RouteRecorder(T, rows=4)
    try:
        traced, _ = _profiled(params)
    finally:
        rec.close()
    assert T._moe_ffn is rec.ffn_fn and T.moe_route is rec.route_fn
    assert np.array_equal(plain.tokens, traced.tokens)
    assert len(rec.calls) == CFG.n_layers * (1 + NEW)
    assert rec.first_rows.shape == (4, CFG.d_model)
    L = CFG.n_layers
    kept = [int(r.keep.sum()) for r in rec.calls]
    assert device.read_counters() == {"prefill": sum(kept[:L]),
                                      "decode": sum(kept[L:])}
    device.reset_counters()


def test_nothing_recorded_without_a_profiler(params, monkeypatch):
    made = []

    def fast(name):
        made.append(name)
        raise AssertionError("a span recorded without a profiler")

    monkeypatch.setattr(device, "_RecordFunctionFast", fast)
    device.reset_counters()
    _serve(params)
    assert made == []
    assert device.read_counters() == {} and device._PENDING == {}
    assert device.span("lm.prefill") is device.span("serve.step")


def test_served_bits_equal_with_and_without_the_profiler(params):
    plain = _serve(params)
    traced, _ = _profiled(params)
    device.reset_counters()
    assert np.array_equal(plain.tokens, traced.tokens)
    assert torch.equal(plain.prefill_logits, traced.prefill_logits)
    assert torch.equal(plain.logits, traced.logits)


def test_count_keeps_tensors_until_read():
    """A mask is kept as it is (no reduction while the profiler records)
    and summed at the read, under the phase of the traced call running;
    nothing counts outside a phase or without a profiler."""
    device.reset_counters()
    mask = torch.tensor([True, False, True])
    counted = device.traced("t.decode", phase="decode")(device.count_kept)
    counted(mask)
    assert device.read_counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        device.count_kept(mask)
        counted(mask)
        counted(mask[:1])
        assert device._PENDING["decode"][0] is mask
        assert device._PHASE is None
    assert device.read_counters() == {"decode": 3}
    device.reset_counters()


def test_no_counters_on_dtensors(params, tmp_path):
    """The mesh path (``DTensor`` inputs) counts nothing."""
    from torch.distributed.tensor import Replicate, distribute_tensor

    from repro_torch.models import common as cm
    from tests import torch_mesh

    x = torch.randn(B, S, CFG.d_model, generator=torch.Generator()
                    .manual_seed(1))
    lp = {k: a[0] for k, a in params["layers"].items()}
    prefill_phase = device.traced("t.prefill", phase="prefill")(T._moe_ffn)
    device.reset_counters()
    with torch_mesh.one_rank_mesh(tmp_path, (1, 1)) as mesh, \
            cm.use_mesh(mesh):
        rep = [Replicate(), Replicate()]
        xd = distribute_tensor(x, mesh, rep)
        lpd = {k: distribute_tensor(v, mesh, rep) for k, v in lp.items()}
        with torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]):
            out, _ = prefill_phase(xd, lpd, CFG)
    assert device.read_counters() == {}
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        want, _ = prefill_phase(x, lp, CFG)
    assert device.read_counters()["prefill"] > 0
    device.reset_counters()
    torch.testing.assert_close(out.full_tensor(), want)
