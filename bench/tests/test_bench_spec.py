"""The harness finds its cells, configurations, traffic and metrics by
name, and BENCHMARK.json keeps to the limits of its format."""

import json
import re

import pytest
import torch

from bench import check, spec, traffic as tr

BENCH = spec.load_benchmark()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "bench/run.py"]
    assert BENCH["paths"] == ["bench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_found_by_name(name):
    cell = spec.load_cell(name)
    tr.check(cell.traffic)
    assert cell.settings["check_batches"] >= 1
    assert cell.settings["trace_batches"] >= 1
    assert cell.settings["limits"]
    assert set(cell.settings["limits"]) <= set(check.NUMBERS)
    assert {m["name"] for m in cell.end_to_end} >= {"setup_s", "peak_mem_gib"}
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    moved = {m["moves"] for m in cell.per_layer}
    assert moved <= {m["name"] for m in cell.end_to_end}


def test_unknown_cell_raises():
    with pytest.raises(KeyError):
        spec.load_cell("no.such_cell")


@pytest.mark.parametrize("name", METRICS)
def test_metric_reader_found_by_name(name):
    assert callable(spec.metric_reader(name).read)


def test_names_units_and_bounds():
    seen = set()
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for entry in BENCH[group]:
            assert NAME.match(entry["name"]) and entry["name"] not in seen
            seen.add(entry["name"])
    for m in BENCH["end_to_end"]:
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
        assert m["better"] in ("lower", "higher")
    assert any(m["name"] == "setup_s" for m in BENCH["end_to_end"])
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer",
                          "moves", "workloads"}
        assert set(m["workloads"]) <= set(CELLS)
    for w in BENCH["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
        assert (w["config"], w["traffic"]) not in seen
        seen.add((w["config"], w["traffic"]))


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    conf = json.loads((spec.ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["reduced"] == entry["reduced"]
    assert entry["file"].startswith("bench/configs/")
    port = conf["port"]
    # the port group runs the published widths
    assert port["d_model"] == conf["hidden_size"]
    assert port["n_q"] == conf["num_attention_heads"]
    assert port["n_kv"] == conf["num_key_value_heads"]
    assert port["vocab"] == conf["vocab_size"]
    assert port["top_k"] == conf["num_experts_per_tok"]
    assert port["n_layers"] == conf["num_hidden_layers"]
    assert port["norm_eps"] == conf["rms_norm_eps"]
    assert port["rope_theta"] == conf["rope_theta"]
    experts = conf.get("n_routed_experts", conf.get("num_local_experts"))
    assert port["n_experts"] == experts
    width = conf.get("moe_intermediate_size", conf["intermediate_size"])
    assert port["d_ff_expert"] == width
    assert port["n_shared_experts"] == conf.get("n_shared_experts", 0)
    cfg = spec.lm_config(conf)
    assert cfg.use_flash_kernel and cfg.n_layers == port["n_layers"]


def test_seeds_draw_the_same_prompts(cpu):
    t = {"batch": 2, "prompt_len": 5}
    big = 2 ** 31 + 977
    a = tr.prompts(t, 100, big, 3, cpu)
    assert a.dtype.is_floating_point is False and a.shape == (2, 5)
    assert a.equal(tr.prompts(t, 100, big, 3, cpu))
    assert not a.equal(tr.prompts(t, 100, big, 4, cpu))
    assert 0 <= tr.mix(big, 3) < 2 ** 63


def test_traffic_files_found_by_name():
    """Every traffic file passes the generator's check, those no cell runs
    yet among them."""
    names = sorted(p.stem for p in (spec.ROOT / "bench" / "traffic").glob(
        "*.json"))
    assert {"prefill_2k", "decode_b160", "decode_b64", "prefill_mixed",
            "prefill_skewed"} <= set(names)
    for name in names:
        t = spec.load_traffic(name)
        tr.check(t)
        assert t["about"]


def test_prompt_lengths_cycle_by_batch(cpu):
    t = {"batch": 2, "prompt_len": [3, 5, 4], "ids": "uniform"}
    assert [tr.prompt_len(t, i) for i in range(5)] == [3, 5, 4, 3, 5]
    assert tr.prompts(t, 100, 7, 4, cpu).shape == (2, 5)
    assert tr.lengths({"prompt_len": 6}) == [6]


def test_zipf_ids_stay_in_their_share_and_skew(cpu):
    t = {"batch": 4, "prompt_len": 500, "ids": "zipf", "vocab_share": 0.1,
         "zipf_s": 1.0}
    a = tr.prompts(t, 1000, 2 ** 31 + 5, 0, cpu)
    assert a.dtype == torch.int32 and a.shape == (4, 500)
    assert 0 <= int(a.min()) and int(a.max()) < 100
    assert a.equal(tr.prompts(t, 1000, 2 ** 31 + 5, 0, cpu))
    counts = torch.bincount(a.flatten().long(), minlength=100)
    # weight 1 / (r + 1): id 0 is drawn about twice as often as id 1, and
    # far more often than id 99
    assert counts[0] > 1.5 * counts[1] and counts[0] > 20 * counts[99]


@pytest.mark.parametrize("bad", [{"loop": "open"}, {"ids": "normal"},
                                 {"prompt_len": [8, 30]},
                                 {"ids": "zipf", "vocab_share": 0.0,
                                  "zipf_s": 1.0},
                                 {"prompt_len": []}])
def test_traffic_check_refuses(bad):
    good = {"loop": "closed", "batch": 2, "prompt_len": 8, "new_tokens": 2,
            "max_seq": 16, "ids": "uniform"}
    tr.check(good)
    with pytest.raises(ValueError):
        tr.check(good | bad)
