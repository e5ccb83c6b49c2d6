#!/usr/bin/env python3
"""The port's benchmark: one cell, one run, one process.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Makes the cell's weights on the card from the seed, warms up the cell's
own shapes, then drives ``repro_torch.launch.serve.generate`` in a closed
loop of one client for the window: batch after batch of the cell's traffic,
the window starting at the first batch and ending with the first batch to
finish after ``--seconds``.  Then it checks the served tokens against the
plain reference (``check.py``) and prints one JSON line: ``--trace 0`` the
cell's end-to-end metrics, ``--trace 1`` its per-layer metrics: those
read from the program's own walls over the same untraced window, those
read from the device over a few more batches served under the profiler
(the cell's ``trace_batches``), set against the untraced window's walls
where they need a wall.  Each metric's reader is
``bench/metrics/<name>.py``.

It refuses to run without enough CUDA cards, and it refuses to print a
result when the JAX package, JAX or flax has been imported.  Caches of the
program's builds stay inside the checkout (``build/``).
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import statistics  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
FORBIDDEN = ("jax", "jaxlib", "flax", "repro")
WEIGHTS_STREAM = 2 ** 41        # traffic.mix index of the weights' seed


for _p in (ROOT / "src", ROOT):          # the program, and this package
    if str(_p) not in sys.path:
        sys.path.insert(0, str(_p))

import torch  # noqa: E402

from bench import check, spec, traffic as tr, weights  # noqa: E402


@dataclasses.dataclass
class Batch:
    index: int                 # the traffic's batch index
    requests: int
    prompt_tokens: int
    new_tokens: int            # generated tokens a request
    call_s: float              # host wall of the whole call
    ttft_s: float | None       # call to first token on the host
    prefill_s: float | None    # the program's own synchronised walls
    decode_s: float | None
    served: torch.Tensor | None  # (B, max(1, new_tokens)) int on the host
    logits: torch.Tensor | None  # (B, V) last-token logits of the prefill
    ok: bool


@dataclasses.dataclass
class Run:
    """What a metric's reader reads."""
    cell: spec.Cell
    port: dict                 # the configuration's ``port`` group
    traffic: dict
    batches: list
    window_s: float
    setup_s: float
    window_peak_bytes: int | None
    trace: object | None       # trace.Trace of the batches served under
                               # the profiler (a traced run)
    traced: list = dataclasses.field(default_factory=list)
                               # those batches

    def untraced_wall_s(self) -> float | None:
        """What the traced batches would take without the profiler: for
        each, the median host wall of the window's calls of its shape
        (the profiler's host activity slows the host, not the device)."""
        walls: dict = {}
        for b in self.batches:
            if b.ok:
                walls.setdefault(_shape(b), []).append(b.call_s)
        if not self.traced or any(_shape(b) not in walls
                                  for b in self.traced):
            return None
        return sum(statistics.median(walls[_shape(b)]) for b in self.traced)


def _shape(b: Batch) -> tuple:
    return b.requests, b.prompt_tokens, b.new_tokens


def use_checkout_caches() -> None:
    """Every kernel cache in a fixed directory inside the checkout, before
    CUDA starts: the program's own ``nvcc`` builds go to ``build/kernels``,
    and these to ``build/cache``."""
    cache = ROOT / "build" / "cache"
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(cache / "cuda")


def forbidden_modules(names=None) -> list:
    """Of the loaded modules (or ``names``), the top-level names that are
    JAX's, flax's or the JAX package's, compared whole."""
    names = list(sys.modules) if names is None else names
    return sorted({m.split(".")[0] for m in names} & set(FORBIDDEN))


def serve_batch(params, cfg, traffic: dict, vocab: int, seed: int,
                index: int, device) -> Batch:
    """One batch of the closed loop: draw its prompts, serve them, and
    bring the first tokens (new_tokens = 0) or all tokens to the host."""
    from repro_torch.launch import serve

    prompts = tr.prompts(traffic, vocab, seed, index, device)
    b, s = prompts.shape
    new = traffic["new_tokens"]
    t0 = time.perf_counter()
    try:
        gen = serve.generate(params, prompts, cfg, new, traffic["max_seq"],
                             device=device)
    except RuntimeError as exc:           # non-finite logits
        print(f"[bench] batch {index} failed: {exc}", file=sys.stderr)
        return Batch(index, b, b * s, new, time.perf_counter() - t0, None,
                     None, None, None, None, False)
    if new == 0:
        served = gen.prefill_logits.argmax(-1)[:, None].cpu()
        ttft = time.perf_counter() - t0
    else:
        served = torch.from_numpy(gen.tokens)
        ttft = gen.prefill_s
    call = time.perf_counter() - t0
    return Batch(index, b, b * s, new, call, ttft, gen.prefill_s,
                 gen.decode_s, served, gen.prefill_logits, True)


def warm_up(params, cfg, traffic: dict, vocab: int, seed: int, device):
    """The cell's own shapes, twice: its prefill at each prompt length the
    traffic cycles through, and (when it decodes) a decode step at its
    batch and cache length."""
    for n in sorted(set(tr.lengths(traffic))):
        warm = dict(traffic, prompt_len=n,
                    new_tokens=min(traffic["new_tokens"], 2))
        for _ in range(2):
            serve_batch(params, cfg, warm, vocab, seed, tr.WARMUP, device)
    if device.type == "cuda":
        torch.cuda.synchronize()


def serve_window(params, cfg, traffic: dict, vocab: int, seed: int,
                 seconds: float, device) -> tuple:
    """(batches, window_s): the closed loop until a batch finishes after
    ``seconds``."""
    batches = []
    t0 = time.perf_counter()
    while True:
        batches.append(serve_batch(params, cfg, traffic, vocab, seed,
                                   len(batches), device))
        elapsed = time.perf_counter() - t0
        if elapsed >= seconds:
            return batches, elapsed


def check_batches(params, cell: spec.Cell, seed: int, batches: list,
                  device) -> tuple:
    """(correct, checks) of a sample of the window's batches."""
    port = cell.config["port"]
    served = [b for b in batches if b.ok]
    picked = [served[i] for i in check.sample(
        len(served), cell.settings["check_batches"], seed)]
    got = [check.readings(params, port, cell.traffic, seed, b.index,
                          b.served, device, b.logits) for b in picked]
    failed = sum(b.requests for b in batches if not b.ok)
    return check.judge(got, failed, cell.settings["limits"])


def run_cell(cell: spec.Cell, seed: int, seconds: float, traced: bool,
             device, t_start: float = _T_START) -> dict:
    """One run of ``cell``; returns the result line's object (device keys
    only on a CUDA device)."""
    from bench.trace import Recorder

    port = cell.config["port"]
    tr.check(cell.traffic)
    cfg = spec.lm_config(cell.config)
    params = weights.make_params(port, tr.mix(seed, WEIGHTS_STREAM), device)
    warm_up(params, cfg, cell.traffic, port["vocab"], seed, device)
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.synchronize()
        setup_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start
    batches, window_s = serve_window(params, cfg, cell.traffic,
                                     port["vocab"], seed, seconds, device)
    window_peak = torch.cuda.max_memory_allocated(device) if cuda else None
    calls = sorted(b.call_s for b in batches)
    print(f"[bench] window {window_s:.3f} s: {len(batches)} batches, a call "
          f"{calls[0]:.4f} / {calls[len(calls) // 2]:.4f} / {calls[-1]:.4f} s "
          f"(least / median / most)", file=sys.stderr)
    traced_batches = []
    with Recorder(traced) as rec:
        if traced:
            traced_batches = [
                serve_batch(params, cfg, cell.traffic, port["vocab"], seed,
                            len(batches) + i, device)
                for i in range(cell.settings["trace_batches"])]
    run = Run(cell, port, cell.traffic, batches, window_s, setup_s,
              window_peak, rec.trace, traced_batches)
    metrics = {}
    for m in (cell.per_layer if traced else cell.end_to_end):
        value = spec.metric_reader(m["name"]).read(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device_info = {}
    if cuda:
        device_info = {"platform": "gpu",
                       "kind": torch.cuda.get_device_name(device),
                       "count": 1,
                       "memory_peak_bytes": max(setup_peak, window_peak)}
        if rec.trace is not None:
            device_info |= {"busy_s": rec.trace.busy_s(),
                            "window_s": rec.trace.window_s}
        torch.cuda.empty_cache()
    batches += traced_batches
    correct, checks = check_batches(params, cell, seed, batches, device)
    result = {"correct": correct,
              "attempted": sum(b.requests for b in batches),
              "failed": checks["failed"]["value"],
              "metrics": metrics, "device": device_info}
    if rec.trace is not None:
        result["breakdown"] = rec.trace.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    use_checkout_caches()
    bench = spec.load_benchmark()
    chips = {w["name"]: w["chips"] for w in bench["workloads"]}
    if args.workload not in chips:
        print(f"[bench] no workload {args.workload!r}", file=sys.stderr)
        return 2
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < chips[args.workload]:
        print(f"[bench] {args.workload} needs {chips[args.workload]} CUDA "
              f"card(s); this machine has "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}"
              f": no result", file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace),
                      torch.device("cuda", 0))
    bad = forbidden_modules()
    if bad:
        print(f"[bench] forbidden modules loaded: {bad}: no result",
              file=sys.stderr)
        return 3
    print(json.dumps(result), flush=True)
    for name, c in result["checks"].items():
        print(f"[check] {name} {c['value']!r} {c['pass']} {c['limit']!r}",
              file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
