#!/usr/bin/env python3
"""Readings that set a cell's limits: the program's and the control's.

    python3 bench/control.py --workload <cell> --seeds 1,2,3 [--control-seeds 1,2,3]

For each seed, in one process: the cell's weights from the seed, a warm-up,
then the cell's ``check_batches`` batches served by the program at the
cell's own sizes, judged as a run judges its sample (``check.judge`` with
the cell's limits: ``correct``).
For the control seeds the reference in fp8 (``reference/lm.py``,
``quant="fp8"``) is put in the program's place at the same positions, and
the float32 reference reads the gap of each token it puts first and the
error of its last-token logits; those readings go through the same
``check.judge`` with the same limits (``control_correct``, which has to
come out false).  Prints one JSON line a seed with both verdicts, the
numbers judged and the statistics of each reading (``check.readings``).
Needs the card.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import run  # also puts the program and this package on the path
import torch

from bench import check, spec, traffic as tr, weights


def stats(g: torch.Tensor) -> dict:
    g = g.double()
    return {"max": float(g.max()), "mean": float(g.mean()),
            "median": float(g.median()),
            "p75": float(torch.quantile(g, 0.75)),
            "p90": float(torch.quantile(g, 0.90)),
            "share_off": float((g > 0).double().mean()), "n": g.numel()}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    args = ap.parse_args(argv)
    run.use_checkout_caches()
    if not torch.cuda.is_available():
        print("[control] needs a CUDA card", file=sys.stderr)
        return 2
    dev = torch.device("cuda", 0)
    cell = spec.load_cell(args.workload)
    port, traffic = cell.config["port"], cell.traffic
    cfg = spec.lm_config(cell.config)
    ctl = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in (int(s) for s in args.seeds.split(",")):
        params = weights.make_params(port, tr.mix(seed, run.WEIGHTS_STREAM),
                                     dev)
        run.warm_up(params, cfg, traffic, port["vocab"], seed, dev)
        batches = [run.serve_batch(params, cfg, traffic, port["vocab"], seed,
                                   i, dev)
                   for i in range(cell.settings["check_batches"])]
        t0 = time.perf_counter()
        got = [check.readings(params, port, traffic, seed, b.index, b.served,
                              dev, b.logits, control=seed in ctl)
               for b in batches]
        failed = sum(b.requests for b in batches if not b.ok)
        limits = cell.settings["limits"]
        correct, checks = check.judge(got, failed, limits)
        line = {"workload": args.workload, "seed": seed,
                "reference_s": time.perf_counter() - t0,
                "correct": correct,
                "numbers": {k: c["value"] for k, c in checks.items()}}
        if seed in ctl:
            ctl_correct, ctl_checks = check.judge(
                [check.control_view(g) for g in got], 0, limits)
            line |= {"control_correct": ctl_correct,
                     "control_numbers": {k: c["value"]
                                         for k, c in ctl_checks.items()}}
        for k in got[0]:
            line[k] = stats(torch.cat([g[k] for g in got]))
        print(json.dumps(line), flush=True)
        del params, batches
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
