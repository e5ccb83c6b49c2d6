"""Each metric's arithmetic, on synthetic runs and traces."""

import dataclasses

import pytest
import torch

from bench import roofline, run as bench_run, spec
from bench.tests.conftest import tiny_config
from bench.trace import NO_HOST_OP, Trace, read_events

PORT = {"n_layers": 2, "d_model": 8, "n_q": 2, "n_kv": 1, "d_head": 4,
        "vocab": 10, "qkv_bias": False, "n_experts": 4, "top_k": 2,
        "d_ff_expert": 3, "n_shared_experts": 1}
TRAFFIC = {"batch": 2, "prompt_len": 6, "new_tokens": 3}


@dataclasses.dataclass
class B:
    requests: int = 2
    prompt_tokens: int = 12
    new_tokens: int = 3
    ttft_s: float = 0.1
    prefill_s: float = 0.1
    decode_s: float = 0.3
    call_s: float = 0.5
    ok: bool = True


@dataclasses.dataclass
class R:
    batches: list
    window_s: float = 2.0
    setup_s: float = 7.5
    window_peak_bytes: int = 3 * 2 ** 30
    trace: object = None
    port: dict = dataclasses.field(default_factory=lambda: PORT)
    traffic: dict = dataclasses.field(default_factory=lambda: TRAFFIC)
    traced: list = dataclasses.field(default_factory=list)

    untraced_wall_s = bench_run.Run.untraced_wall_s


def read(name, run):
    return spec.metric_reader(name).read(run)


def synthetic_trace():
    # a window of 100 ns: kernels at 10-30 and 25-40 (busy 30), a copy at
    # 60-70 (busy 10); two decode_step spans, the first launching 2 kernels
    ops = [("tc_kernel<128>", 10, 30, 1), ("gemm", 25, 40, 2),
           ("Memcpy DtoH", 60, 70, 3), ("gemm", 80, 85, 4)]
    launches = {1: 5, 2: 6, 4: 75}
    spans = {"bench.window": [(0, 100)],
             "bench.decode_step": [(4, 7), (50, 55)],
             "bench.prefill": [(0, 50)]}
    host = [(0, 100, "bench.window"), (38, 58, "aten::mul"),
            (70, 72, "aten::add")]
    return Trace(ops, launches, spans, host, (0, 100))


def test_trace_arithmetic():
    t = synthetic_trace()
    assert t.window_s == 100e-9
    assert t.busy_intervals() == [[10, 40], [60, 70], [80, 85]]
    assert t.busy_s() == pytest.approx(45e-9)
    assert t.kernel_s(("tc_kernel",)) == pytest.approx(20e-9)
    assert len(t.kernels()) == 3
    assert t.launched_in("bench.decode_step") == 2
    assert t.host_op_at(45) == "aten::mul"
    assert t.host_op_at(90) == "bench.window"
    assert Trace([], {}, {}, [], (0, 1)).host_op_at(0) == NO_HOST_OP
    gaps = dict(t.breakdown()["idle_gaps"])
    # idle 0-10, 40-60, 70-80, 85-100: 10 + 15 (window) + 20 (mul) + 10 (add)
    assert gaps == pytest.approx({"bench.window": 25e-9, "aten::mul": 20e-9,
                                  "aten::add": 10e-9})
    ops = dict(t.breakdown()["device_ops"])
    assert ops["gemm"] == pytest.approx(20e-9)


def test_read_events_sorts_kinds():
    class E:
        def __init__(self, name, dev, start, dur, corr):
            self._v = (name, dev, start, dur, corr)

        def name(self): return self._v[0]
        def device_type(self): return self._v[1]
        def start_ns(self): return self._v[2]
        def duration_ns(self): return self._v[3]
        def correlation_id(self): return self._v[4]

    cuda = object()
    t = read_events([E("bench.window", "cpu", 0, 100, 0),
                     E("bench.window", cuda, 0, 100, 0),
                     E("cudaLaunchKernel", "cpu", 3, 1, 9),
                     E("k", cuda, 5, 10, 9),
                     E("aten::mm", "cpu", 2, 4, 1)], cuda)
    assert t.device_ops == [("k", 5, 15, 9)]
    assert t.launches == {9: 3}
    assert t.window == (0, 100)
    assert [op[2] for op in t.host_ops] == ["bench.window", "aten::mm"]


def test_end_to_end_readers():
    run = R([B(ttft_s=0.1), B(ttft_s=0.2), B(ok=False)])
    assert read("setup_s", run) == 7.5
    assert read("prefill_tok_per_s", run) == pytest.approx(24 / 2.0)
    assert read("output_tok_per_s", run) == pytest.approx(12 / 2.0)
    # four requests: 0.1, 0.1, 0.2, 0.2 -> numpy's 95th percentile 0.2
    assert read("ttft_p95_ms", run) == pytest.approx(200.0)
    assert read("peak_mem_gib", run) == 3.0
    assert read("peak_mem_gib", R([], window_peak_bytes=None)) is None


def test_flop_and_byte_counts_against_the_program():
    c = tiny_config("dsmoe")["port"]
    cfg = spec.lm_config(tiny_config("dsmoe"))
    per_layer = roofline.active_layer_weights(c)
    d = c["d_model"]
    # LMConfig counts the norms and the embedding and head besides
    assert per_layer * c["n_layers"] == cfg.active_param_count() \
        - 2 * c["vocab"] * d - d - 2 * d * c["n_layers"]
    assert roofline.visible_pairs(4) == 10
    f = roofline.prefill_flops(PORT, 2, 6)
    dense = 2 * roofline.active_layer_weights(PORT) * 2 * 12
    assert f == dense + 4 * 2 * 2 * 4 * 2 * 21 + 2 * 8 * 10 * 2
    assert roofline.experts_touched(PORT, 1) == pytest.approx(2.0)
    b = roofline.decode_step_bytes(PORT, 1, 0)
    assert b > 2 * (2 * roofline.attn_weights(PORT) + 8 * 10)


def test_per_layer_readers():
    t = synthetic_trace()
    # the traced batch took 100 ns under the profiler; the window's calls of
    # its shape took 90 and 110 without it (median 100): idle 55 of 100
    run = R([B(call_s=90e-9), B(call_s=110e-9)], trace=t,
            traced=[B(call_s=400e-9)])
    assert read("idle_share.prefill", run) == pytest.approx(55.0)
    assert read("idle_share.decode", run) == pytest.approx(55.0)
    # a profiler that doubles the host's wall moves nothing
    assert read("idle_share.decode", dataclasses.replace(
        run, trace=dataclasses.replace(t, window=(0, 200)))) \
        == pytest.approx(55.0)
    assert read("launches_per_step.decode", run) == pytest.approx(1.0)
    bound, _ = roofline.b3_bound(2, 2, 1, 6, 4)
    assert read("attn_roofline.prefill", run) == pytest.approx(
        100 * 1 * 2 * bound / 20e-9)
    flops = roofline.prefill_flops(PORT, 2, 6)
    assert read("prefill_mfu", run) == pytest.approx(
        100 * flops / 989e12 / 0.1)
    steps = [roofline.decode_step_flops(PORT, 2, 6 + j) for j in range(3)]
    assert read("decode_mfu", run) == pytest.approx(
        100 * sum(steps) / 989e12 / 0.3)
    least = sum(roofline.least_time_s(
        roofline.decode_step_flops(PORT, 2, 6 + j),
        roofline.decode_step_bytes(PORT, 2, 6 + j)) for j in range(3))
    assert read("decode_roofline", run) == pytest.approx(100 * least / 0.3)


@pytest.mark.parametrize("name", ["idle_share.prefill", "attn_roofline.prefill",
                                  "launches_per_step.decode"])
def test_trace_readers_read_nothing_without_a_trace(name):
    assert read(name, R([B()], traced=[B()])) is None
    empty = Trace([], {}, {}, [], (0, 10))
    assert read(name, R([B()], trace=empty, traced=[B()])) is None


def test_untraced_wall_by_shape():
    short, long = B(prompt_tokens=8, call_s=1.0), B(prompt_tokens=16,
                                                    call_s=3.0)
    run = R([short, long, dataclasses.replace(long, call_s=5.0),
             B(prompt_tokens=16, call_s=99.0, ok=False)],
            traced=[dataclasses.replace(long, call_s=70.0),
                    dataclasses.replace(short, call_s=20.0)])
    assert run.untraced_wall_s() == pytest.approx(4.0 + 1.0)
    # a traced shape the window never served has no untraced wall
    assert R([short], traced=[long]).untraced_wall_s() is None
    assert R([short]).untraced_wall_s() is None


def test_shares_of_nothing():
    assert roofline.share(1.0, 0.0) is None
    assert read("prefill_mfu", R([])) is None


def test_roofline_share_stays_under_100_on_real_shapes():
    c = tiny_config("phi")["port"] | {"d_model": 4096, "n_q": 32, "n_kv": 8,
                                      "d_head": 128}
    ops, by = roofline.b3_bound(8, 32, 8, 2048, 128)
    assert by == "operations"
    assert ops == pytest.approx(4 * 8 * 32 * 128 * 2048 * 2049 / 2 / 989e12)
    assert torch.isfinite(torch.tensor(roofline.prefill_flops(c, 8, 2048)))
