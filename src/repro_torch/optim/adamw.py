"""AdamW and its schedule over trees of tensors (port of the JAX package's
``optim/adamw.py``).

The state keeps float32 master weights, m and v whatever the parameters'
dtype (mixed precision), in the reference's layout ``{"step", "master",
"m", "v"}``, so either package restores the other's checkpoints.

``update`` computes the reference's values one leaf at a time, in place.
The reference casts the whole gradient tree to float32 first, which at
gemma3-4b's width is 14.5 GiB beside 57.8 GiB of state; here each leaf's
float32 gradient is made, used and freed in turn, ``m``, ``v`` and
``master`` are updated in place and the parameter is written from the
master with ``copy_``, so at most two float32 temporaries of one leaf live
at once.  The clipping norm is accumulated leaf by leaf the same way.  The
ops round one at a time, as the reference's do before XLA fuses them, so
the tests hold the values to a tolerance.  Every scalar (lr, the bias
corrections, the clip scale) stays a tensor on the parameters' device: a
step reads nothing back to the host.

``zero_specs`` gives the ZeRO-1 specs of the state: each leaf's parameter
spec with the data axes on its first free dim that they divide.
"""

from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch import tree
from repro_torch.models.common import P, is_dtensor, map_specs


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def schedule(cfg: AdamWConfig, step) -> torch.Tensor:
    """Linear warmup, then cosine decay to ``min_lr_frac``: a float32 0-dim
    tensor on ``step``'s device (a Python number: the CPU), computed in
    float32 as the reference computes it."""
    step = torch.as_tensor(step).to(torch.float32)
    warm = torch.clamp(step / max(cfg.warmup_steps, 1), max=1.0)
    t = torch.clamp((step - cfg.warmup_steps)
                    / max(cfg.total_steps - cfg.warmup_steps, 1), 0.0, 1.0)
    cos = 0.5 * (1 + torch.cos(math.pi * t))
    frac = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * cos
    return cfg.lr * warm * frac


def init_state(params) -> dict:
    """Step 0, float32 copies of the parameters as the master weights, and
    zero m and v."""
    first = tree.leaves(params)[0]
    f32 = lambda x: x.detach().to(torch.float32, copy=True)
    zeros = lambda x: torch.zeros(x.shape, dtype=torch.float32,
                                  device=x.device)
    return {
        "step": torch.zeros((), dtype=torch.int32, device=first.device),
        "master": tree.map_leaves(f32, params),
        "m": tree.map_leaves(zeros, params),
        "v": tree.map_leaves(zeros, params),
    }


def _clip_scale(grads: list, max_norm: float):
    """(scale, norm): the global norm of the leaves, a float32 sum of
    squares accumulated leaf by leaf in leaf order (one float32 copy of one
    leaf at a time), and ``min(1, max_norm / max(norm, 1e-9))``."""
    total = None
    for g in grads:
        s = g.detach().to(torch.float32, copy=True).square_().sum()
        total = s if total is None else total + s
    gn = torch.sqrt(total)
    return torch.clamp(max_norm / torch.clamp(gn, min=1e-9), max=1.0), gn


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, the norm)."""
    scale, gn = _clip_scale(tree.leaves(grads), max_norm)
    return tree.map_leaves(lambda g: g * scale, grads), gn


@torch.no_grad()
def update(cfg: AdamWConfig, params, state: dict, grads, decay_mask=None):
    """One AdamW step, in place on ``params`` and on ``state``'s master, m
    and v (``state["step"]`` becomes a new tensor).  Returns ``(params,
    state, {"lr", "grad_norm"})``.  Weight decay applies to the leaves of
    ``decay_mask`` that are true (default: ``ndim >= 2``)."""
    p_leaves = tree.leaves(params)
    g_leaves = tree.leaves(grads)
    if decay_mask is None:
        d_leaves = [p.ndim >= 2 for p in p_leaves]
    else:
        d_leaves = tree.leaves(decay_mask)
    scale, gnorm = _clip_scale(g_leaves, cfg.clip_norm)
    step = state["step"] + 1
    lr = schedule(cfg, step)
    b1c = 1 - torch.pow(cfg.b1, step.to(torch.float32))
    b2c = 1 - torch.pow(cfg.b2, step.to(torch.float32))
    for p, g, master, m, v, decay in zip(
            p_leaves, g_leaves, tree.leaves(state["master"]),
            tree.leaves(state["m"]), tree.leaves(state["v"]), d_leaves):
        g32 = g.to(torch.float32, copy=True).mul_(scale)
        m.mul_(cfg.b1).add_(g32, alpha=1 - cfg.b1)
        tmp = torch.square(g32)
        v.mul_(cfg.b2).add_(tmp, alpha=1 - cfg.b2)
        # delta = (m / b1c) / (sqrt(v / b2c) + eps), in the two temporaries
        # (a DTensor leaf, under a mesh: in new ones, the same values)
        if is_dtensor(g32):
            denom = torch.div(v, b2c).sqrt_().add_(cfg.eps)
            delta = torch.div(m, b1c).div_(denom)
        else:
            denom = torch.div(v, b2c, out=g32).sqrt_().add_(cfg.eps)
            delta = torch.div(m, b1c, out=tmp).div_(denom)
        del g32, denom
        if decay:
            delta.add_(master, alpha=cfg.weight_decay)
        master.sub_(delta.mul_(lr))
        del tmp, delta
        p.copy_(master)
    state["step"] = step
    return params, state, {"lr": lr, "grad_norm": gnorm}


def zero_specs(param_specs, params_shape, data_axes=("pod", "data"),
               data_size: int = 16):
    """State specs: each parameter's spec with the data axes on its first
    dim that no axis shards and ``data_size`` divides.  ``param_specs`` and
    ``params_shape`` (tensors, meta or not) are trees like the
    parameters."""
    def one(spec, arr):
        shape = tuple(arr.shape)
        entries = list(spec) + [None] * (len(shape) - len(spec))
        for i, (s, dim) in enumerate(zip(entries, shape)):
            if s is None and dim % data_size == 0 and dim > 0:
                entries[i] = (tuple(data_axes) if len(data_axes) > 1
                              else data_axes[0])
                break
        return P(*entries)

    st = map_specs(one, param_specs, params_shape)
    return {"step": P(), "master": st, "m": st, "v": st}
