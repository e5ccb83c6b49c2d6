"""B3's bf16 route (flash attention) in several checkouts, on one card.

Run from the repository root on a machine with one NVIDIA card:

    python3 tools/b3_compare.py ROOT [ROOT ...] [--out FILE]

Each ROOT is a checkout of this repository (for example a ``git archive``
of a commit unpacked under ``build/``).  Each is run in a child process of
its own, in the order given, with ``ROOT/src`` first on the path, so the
child builds and loads that checkout's kernels; give a list such as
``A B B A`` to see the drift between turns.  A child:

1. times ``flash_attention`` at the MoE paths' largest calls, moonshot's
   (B, Hq, Hkv, S, D) = (8, 16, 16, 2048, 128) and phi3.5-moe's
   (8, 32, 8, 2048, 128), causal bf16 on strided (B, S, H, D) views:
   device ms by CUDA events in 10 turns of 5 calls (median, slowest,
   fastest), and the host's time of one call from the wrapper's call to
   its return, with the device idle before it (median of 200 calls);
2. serves moonshot-v1-16b-a3b at full width (48 layers, weights from seed
   0): ``prefill`` of 8 prompts of 2,048 tokens (phase 7b's traffic), one
   warm-up and then 5 walls (median, slowest, fastest), then one prefill
   under ``torch.profiler``: the device's busy time (kernels, copies and
   memsets summed), its idle share of that wall, and B3's device time.

It prints the card's name and power limit, a line for each child, and a
last line with one JSON object, ``{ROOT: [result of each turn]}``, which
``--out`` also writes.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
from pathlib import Path

SHAPES = {"moonshot": (8, 16, 16, 2048, 128),
          "phi3.5-moe": (8, 32, 8, 2048, 128)}
TURNS, REPS, HOST_CALLS, PREFILLS = 10, 5, 200, 5
ARCH = "moonshot-v1-16b-a3b"
TRAFFIC = (8, 2048, 2080)  # requests, prompt tokens, cache length
HERE = str(Path(__file__).resolve())


def child() -> dict:
    import dataclasses
    import time

    import numpy as np
    import torch
    from torch.autograd import DeviceType

    from repro_torch.configs import registry
    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.models import transformer as lm

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev).manual_seed(0)
    out = {}
    for name, (b, hq, hkv, s, d) in SHAPES.items():
        q, k, v = (torch.randn(b, s, h, d, generator=gen, device=dev,
                               dtype=torch.bfloat16).transpose(1, 2)
                   for h in (hq, hkv, hkv))
        call = lambda: ak.flash_attention(q, k, v)  # noqa: E731
        for _ in range(3):
            call()
        torch.cuda.synchronize()
        turns = []
        for _ in range(TURNS):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(REPS):
                call()
            end.record()
            end.synchronize()
            turns.append(start.elapsed_time(end) / REPS)
        host = []
        for _ in range(HOST_CALLS):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e6)
        torch.cuda.synchronize()
        out[name] = dict(ms=float(np.median(turns)), ms_turns=turns,
                         host_us=float(np.median(host)),
                         host_us_spread=[min(host), max(host)])
        del q, k, v

    cfg = dataclasses.replace(registry.get_config(ARCH),
                              use_flash_kernel=True)
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    n_req, prompt_len, max_seq = TRAFFIC
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (n_req, prompt_len)).astype(np.int32)

    def prefill() -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lm.prefill(params, prompts, cfg, max_seq=max_seq, device=dev)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    prefill()
    walls = [prefill() for _ in range(PREFILLS)]
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        traced = prefill()
    busy = b3 = 0
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            busy += e.duration_ns()
            if "tc_kernel" in e.name():
                b3 += e.duration_ns()
    out["prefill"] = dict(wall_ms=float(np.median(walls)), walls_ms=walls,
                          traced_wall_ms=traced, busy_ms=busy / 1e6,
                          idle_share=1 - busy / 1e6 / traced,
                          b3_ms=b3 / 1e6)
    return out


def main(argv: list) -> int:
    out_file = None
    if "--out" in argv:
        i = argv.index("--out")
        out_file, argv = argv[i + 1], argv[:i] + argv[i + 2:]
    if argv and argv[0] == "--child":
        print(json.dumps(child()))
        return 0
    if not argv:
        print(__doc__)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True).stdout
    print(card.strip(), flush=True)
    results: dict = {}
    for root in argv:
        src = str(Path(root).resolve() / "src")
        env = dict(os.environ, PYTHONPATH=src)
        proc = subprocess.run([sys.executable, HERE, "--child"], env=env,
                              cwd=root, capture_output=True, text=True)
        if proc.returncode != 0:
            print(proc.stdout[-4000:], proc.stderr[-4000:], sep="\n")
            raise SystemExit(f"{root}: child exited {proc.returncode}")
        got = json.loads(proc.stdout.strip().splitlines()[-1])
        print(root, json.dumps(got), flush=True)
        results.setdefault(root, []).append(got)
    line = json.dumps(results)
    if out_file:
        Path(out_file).parent.mkdir(parents=True, exist_ok=True)
        Path(out_file).write_text(line + "\n")
    print(line)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
