"""The training step (port of the JAX package's
``configs/cells.py::make_train_step``): gradients accumulated in float32
over microbatches, then AdamW.  The rest of that file, the cells that
lower each (architecture, shape) for a TPU mesh, waits for the cell layer
(ROADMAP A14)."""

from __future__ import annotations

import torch

from repro_torch import tree
from repro_torch.optim import adamw


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of the scalar ``loss_fn(params, batch)``: the
    gradient tree has ``params``' structure and dtypes.  The parameters are
    differentiated through detached aliases, so the caller's tensors keep
    their ``requires_grad`` and an in-place update of them reaches the next
    call."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten_like(params, leaves), batch)
    grads = torch.autograd.grad(loss, leaves)
    return loss.detach(), tree.unflatten_like(params, grads)


def make_train_step(loss_fn, ocfg: adamw.AdamWConfig, microbatches: int = 1):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "lr", "grad_norm"})``.  With ``microbatches > 1`` the batch's leading
    dim is split into that many microbatches, one after another, and their
    gradients and losses are summed in float32 and divided by the count, so
    the activation peak is one microbatch's.  With one, the gradients go to
    ``adamw.update`` in their own dtype: it casts them to float32 a leaf at
    a time, which gives the reference's float32 cast of the whole tree."""

    def step(params, opt_state, batch):
        if microbatches > 1:
            split = {k: v.reshape((microbatches, v.shape[0] // microbatches)
                                  + tuple(v.shape[1:]))
                     for k, v in batch.items()}
            acc, loss = None, None
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in split.items()})
                g = tree.leaves(g)
                if acc is None:
                    acc = [torch.zeros(x.shape, dtype=torch.float32,
                                       device=x.device) for x in g]
                    loss = torch.zeros((), dtype=torch.float32,
                                       device=l.device)
                for a, b in zip(acc, g):
                    a.add_(b)
                loss = loss + l
                del g
            grads = tree.unflatten_like(
                params, [a.div_(microbatches) for a in acc])
            loss = loss / microbatches
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
        params, opt_state, om = adamw.update(ocfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **om}

    return step
