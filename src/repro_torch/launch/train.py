"""Training launcher: ``python -m repro_torch.launch.train --arch <id>
[--steps N] [--device cpu]``.

Trains the REDUCED config of any arch of the registry (LM, GNN or DIN;
``configs/reduced.py::make_reduced``) end to end, as the JAX package's
``launch/train.py`` does: the arch's synthetic batches, AdamW with linear
warmup over the first twentieth of the steps and cosine decay,
checkpoints every ``--ckpt-every`` steps under ``--ckpt-dir/<arch>`` (a
rerun resumes from the latest), on the CUDA card unless ``--device`` says
otherwise.
"""

from __future__ import annotations

import argparse
import os
import tempfile

from repro_torch.configs import registry
from repro_torch.configs.cells import make_train_step
from repro_torch.configs.reduced import make_reduced
from repro_torch.device import resolve_device
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop as TL
from repro_torch.tree import leaves


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=list(registry.ARCHS))
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(
        tempfile.gettempdir(), "repro_torch_train"))
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--metrics-csv", default=None)
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg, init_fn, loss_fn, batch_fn = make_reduced(args.arch, device=dev)
    ocfg = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(args.steps // 20, 1),
                             total_steps=args.steps)

    def init_state():
        params = init_fn()
        n = sum(x.numel() for x in leaves(params))
        print(f"[train] {args.arch}: {n / 1e6:.2f}M params (reduced config) "
              f"on {dev}")
        return {"params": params, "opt": adamw.init_state(params)}

    step = make_train_step(loss_fn, ocfg,
                           microbatches=getattr(cfg, "microbatches", 1))

    def train_step(state, batch):
        params, opt, m = step(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, m

    lcfg = TL.LoopConfig(steps=args.steps,
                         ckpt_dir=os.path.join(args.ckpt_dir, args.arch),
                         ckpt_every=args.ckpt_every,
                         log_every=args.log_every,
                         metrics_csv=args.metrics_csv)
    state, rows = TL.run(lcfg, init_state, train_step, batch_fn)
    losses = [r["loss"] for r in rows if "loss" in r]
    print(f"[train] {args.arch}: loss {losses[0]:.4f} -> {losses[-1]:.4f} "
          f"over {args.steps} steps")
    for r in rows:
        print("  ", r)
    return rows


if __name__ == "__main__":
    main()
