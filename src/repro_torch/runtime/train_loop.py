"""Fault-tolerant training loop (port of the JAX package's
``runtime/train_loop.py``).

Contract:
  * deterministic data: ``batch_fn(step)`` must be reproducible (see
    ``data/tokens.py``) so any restart replays the exact stream;
  * checkpoint every ``ckpt_every`` steps through ``AsyncWriter``
    (write-behind), atomic on disk; on entry the loop resumes from the
    latest checkpoint, each tensor restored onto the device of the state
    ``init_fn`` builds;
  * a step failure (a device error, an injected fault) triggers
    restore-from-latest and replay, up to ``max_restarts`` times;
  * metrics stream to a CSV (host-side).
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
import time
from typing import Any, Callable, Optional

from repro_torch.checkpoint import manager as ckpt


@dataclasses.dataclass
class LoopConfig:
    steps: int = 100
    ckpt_dir: str = dataclasses.field(
        default_factory=lambda: os.path.join(tempfile.gettempdir(),
                                             "repro_torch_ckpt"))
    ckpt_every: int = 25
    keep: int = 3
    log_every: int = 10
    max_restarts: int = 3
    metrics_csv: Optional[str] = None


def run(
    cfg: LoopConfig,
    init_fn: Callable[[], Any],
    step_fn: Callable[[Any, dict], tuple[Any, dict]],
    batch_fn: Callable[[int], dict],
    fault_hook: Optional[Callable[[int], None]] = None,
) -> tuple[Any, list[dict]]:
    """Returns (final_state, metric rows).  A logged row reads its metrics
    back to the host (one device synchronisation)."""
    writer = ckpt.AsyncWriter(cfg.ckpt_dir, cfg.keep)
    rows: list[dict] = []
    restarts = 0

    def make_state():
        start = ckpt.latest_step(cfg.ckpt_dir)
        state = init_fn()
        if start is not None:
            state, meta = ckpt.restore(cfg.ckpt_dir, state)
            return state, int(meta.get("next_step", start))
        return state, 0

    state, step = make_state()
    t0 = time.time()
    while step < cfg.steps:
        try:
            if fault_hook is not None:
                fault_hook(step)
            batch = batch_fn(step)
            state, metrics = step_fn(state, batch)
            if (step % cfg.log_every == 0) or step == cfg.steps - 1:
                row = {"step": step,
                       "time": round(time.time() - t0, 3),
                       **{k: float(v) for k, v in metrics.items()}}
                rows.append(row)
            step += 1
            if step % cfg.ckpt_every == 0 or step == cfg.steps:
                writer.save(step, state, {"next_step": step})
        except (FloatingPointError, RuntimeError, ValueError) as e:
            restarts += 1
            if restarts > cfg.max_restarts:
                raise
            writer.wait()
            state, step = make_state()
            rows.append({"step": step, "restart": restarts,
                         "error": str(e)[:80]})
    writer.wait()
    if cfg.metrics_csv:
        _write_csv(cfg.metrics_csv, rows)
    return state, rows


def _write_csv(path: str, rows: list[dict]) -> None:
    if not rows:
        return
    keys = sorted({k for r in rows for k in r})
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w") as f:
        f.write(",".join(keys) + "\n")
        for r in rows:
            f.write(",".join(str(r.get(k, "")) for k in keys) + "\n")
