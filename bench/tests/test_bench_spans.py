"""The readers of the program's spans and counters (``bench/spans.py`` and
the four metrics that use it), on synthetic traces."""

import dataclasses

import pytest
import torch

from bench import roofline, spans, spec
from bench.tests.test_bench_metrics import PORT, B, R, read
from bench.trace import Trace

NEW = ("attn_roofline.decode", "expert_roofline.prefill",
       "moe_dispatch_share.prefill", "moe_dropped_share.decode")


def program_trace():
    """A prefill span (0-100) and a decode step (200-300) with their layer
    spans, an ``lm.attn.core`` outside both (400-410), and kernels whose
    launches fall inside, outside and in nested spans.  A device op named
    like a span, with no launch, stands for a span's mirror."""
    host = [(0, 100, "lm.prefill"), (5, 25, "lm.attn"),
            (10, 20, "lm.attn.core"), (30, 35, "lm.moe.route"),
            (36, 40, "lm.moe.dispatch"), (40, 60, "lm.moe.experts"),
            (60, 70, "lm.moe.combine"), (85, 90, "lm.logits"),
            (12, 13, "aten::mm"),
            (200, 300, "lm.decode_step"), (205, 225, "lm.attn"),
            (210, 220, "lm.attn.core"), (230, 240, "lm.moe.experts"),
            (400, 410, "lm.attn.core"), (500, 510, "aten::add")]
    # name, launch time, device time (ns)
    kernels = [("tc_kernel", 12, 7), ("softmax", 32, 2), ("index_copy", 38, 3),
               ("nvjet", 45, 11), ("nvjet", 50, 13), ("gather", 65, 5),
               ("rms", 80, 17), ("direct_copy", 212, 19), ("bmm", 215, 23),
               ("nvjet", 235, 29), ("direct_copy", 405, 31), ("add", 505, 37)]
    ops, launches = [], {}
    for corr, (name, t, dur) in enumerate(kernels, start=1):
        launches[corr] = t
        ops.append((name, 1000 + 50 * corr, 1000 + 50 * corr + dur, corr))
    ops.append(("lm.attn.core", 2000, 2100, 999))
    return Trace(ops, launches, {}, sorted(host), (0, 3000))


def test_intervals_by_name_and_nesting():
    t = program_trace()
    assert spans.intervals(t, "lm.attn.core") == [(10, 20), (210, 220),
                                                  (400, 410)]
    assert spans.intervals(t, "lm.attn.core", within="lm.prefill") == [
        (10, 20)]
    assert spans.intervals(t, "lm.attn.core", within="lm.decode_step") == [
        (210, 220)]
    assert spans.intervals(t, "lm.moe.experts", within="lm.attn") == []
    assert spans.intervals(t, "no.such") == []


def test_device_time_inside_outside_and_nested_spans():
    t = program_trace()
    ns = 1e-9
    # inside lm.prefill: every kernel launched at 12-80
    assert spans.device_s(t, ("lm.prefill",)) == pytest.approx(58 * ns)
    assert spans.device_s(t, ("lm.attn.core",)) == pytest.approx(
        (7 + 19 + 23 + 31) * ns)
    assert spans.device_s(t, ("lm.attn.core",), within="lm.decode_step") \
        == pytest.approx(42 * ns)
    # a kernel in nested spans counts once
    assert spans.device_s(t, ("lm.attn", "lm.attn.core"),
                          within="lm.prefill") == pytest.approx(7 * ns)
    assert spans.device_s(t, ("lm.moe.route", "lm.moe.dispatch",
                              "lm.moe.combine")) == pytest.approx(10 * ns)
    # launched outside every span: the add at 505 is nobody's
    every = ("lm.prefill", "lm.decode_step", "lm.attn.core")
    assert spans.device_s(t, every) == pytest.approx(
        (58 + 19 + 23 + 29 + 31) * ns)


def test_a_span_on_the_host_alone():
    """A span is read from the host's ops: a device op that bears its name
    (a mirror, with no launch of its own) adds nothing, and a span that
    launched nothing reads zero."""
    t = program_trace()
    assert spans.device_s(t, ("lm.moe.route",)) == pytest.approx(2e-9)
    assert spans.device_s(t, ("lm.logits",)) == 0
    assert spans.intervals(t, "lm.logits", within="lm.prefill") == [(85, 90)]
    quiet = dataclasses.replace(t, host_ops=[(600, 700, "lm.prefill")])
    assert spans.device_s(quiet, ("lm.prefill",)) == 0


def _run(counters, monkeypatch, **kw):
    monkeypatch.setattr(spans, "kept_slots",
                        lambda phase: (counters or {}).get(phase))
    base = dict(trace=program_trace(), traced=[B()])
    return R([B()], **(base | kw))


def test_readers_on_a_program_trace(monkeypatch):
    # the traced batch routes 2 layers x 2 requests x top 2 x 3 steps = 24
    # decode slots, of which 18 were kept
    run = _run({"prefill": 30, "decode": 18}, monkeypatch)
    least = sum(roofline.least_time_s(4 * 2 * k * 2 * 4, 2 * 2 * k * 1 * 4 * 2)
                for k in (7, 8, 9))           # prompt 6, steps 0-2: keys 7-9
    assert read("attn_roofline.decode", run) == pytest.approx(
        100 * PORT["n_layers"] * least / 42e-9)
    w = roofline.expert_weights(PORT)
    assert read("expert_roofline.prefill", run) == pytest.approx(
        100 * roofline.least_time_s(2 * w * 30, 1 * 4 * w * 2) / 24e-9)
    assert read("moe_dispatch_share.prefill", run) == pytest.approx(
        100 * 10 / 58)
    assert read("moe_dropped_share.decode", run) == pytest.approx(25.0)


@pytest.mark.parametrize("name", NEW)
def test_readers_read_nothing_without_spans_ops_or_counters(name,
                                                            monkeypatch):
    counters = {"prefill": 3, "decode": 3}
    assert read(name, _run(counters, monkeypatch)) is not None
    # no trace (an untraced run), no device ops (a CPU run)
    assert read(name, _run(counters, monkeypatch, trace=None)) is None
    t = program_trace()
    assert read(name, _run(counters, monkeypatch, trace=dataclasses.replace(
        t, device_ops=[]))) is None
    # a program without spans or counters (an older checkout)
    no_spans = dataclasses.replace(t, host_ops=[(0, 600, "aten::mm")])
    if name != "moe_dropped_share.decode":
        assert read(name, _run(counters, monkeypatch, trace=no_spans)) \
            is None
    if name in ("expert_roofline.prefill", "moe_dropped_share.decode"):
        assert read(name, _run(None, monkeypatch)) is None
    if name == "moe_dropped_share.decode":      # no traced decode step
        assert read(name, _run(counters, monkeypatch,
                               traced=[B(new_tokens=0)])) is None


def test_kept_slots_from_the_program(monkeypatch):
    from repro_torch import device

    device.reset_counters()
    assert spans.kept_slots("decode") is None
    counted = device.traced("t.decode", phase="decode")(device.count_kept)
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        counted(torch.tensor([True, False, True]))
    assert spans.kept_slots("decode") == 2
    assert spans.kept_slots("prefill") is None
    device.reset_counters()
    monkeypatch.delattr(device, "read_counters")
    assert spans.kept_slots("decode") is None


def test_entries_name_their_spans():
    per_layer = {m["name"]: m for m in spec.load_benchmark()["per_layer"]}
    for name in NEW:
        m = per_layer[name]
        assert m["source"] == "program_span" and m["workloads"]
        assert m["unit"] == "%"
    assert per_layer["attn_roofline.decode"]["workloads"] == [
        "dsmoe16b.decode_b160"]
    assert per_layer["expert_roofline.prefill"]["moves"] == \
        "prefill_tok_per_s"
