"""Cells (port of the JAX package's ``configs/cells.py``): one (architecture
x input shape) unit of the dry run, and the training step.

A ``Cell`` knows how to build, for a mesh (a ``DeviceMesh`` with named
dims, or None): the step function (train / prefill / decode / serve /
retrieval), its abstract inputs and their shardings.  Abstract inputs are
tensors on the ``meta`` device (shape and dtype, no storage);
``abstract_params`` runs an init function under a mode that sends every
factory op to ``meta`` and drops the generator, so nothing is drawn or
allocated.  A sharding is a ``NamedSharding`` of the mesh and a spec
resolved on it (``resolve_spec`` drops the axes the mesh lacks).
``launch/dryrun.py`` traces cells on a fake process group;
``chip_smoke.py`` runs some of them on the card.

``make_train_step``: gradients accumulated in float32 over microbatches,
then AdamW; with ``grad_specs``, ``DTensor`` gradients (parameters placed
on a mesh, run inside ``common.use_mesh``) go to those specs in float32
(ZeRO-2).
"""

from __future__ import annotations

import dataclasses
from typing import Any, Callable

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch import tree
from repro_torch.models import common as cm
from repro_torch.models.common import P
from repro_torch.optim import adamw


@dataclasses.dataclass
class Cell:
    arch: str
    shape: str
    kind: str                     # train | prefill | decode | serve | retrieval
    model_flops: float            # analytic useful flops per step (global)
    build: Callable[[Any], tuple]  # mesh -> (fn, args, in_sh[, out_sh])
    notes: str = ""
    donate: tuple = ()            # donated arg indices (decode: the cache)

    @property
    def key(self) -> str:
        return f"{self.arch}×{self.shape}"


@dataclasses.dataclass(frozen=True)
class NamedSharding:
    """A spec resolved on a mesh."""
    mesh: Any
    spec: P


def resolve_spec(mesh, spec) -> P:
    """Drop axes not present on this mesh (e.g. 'pod' on a single pod)."""
    return cm.resolve(mesh.mesh_dim_names, spec)


def shardings(mesh, spec_tree):
    """Tree of specs -> tree of ``NamedSharding`` (mesh-resolved)."""
    return cm.map_specs(
        lambda s: NamedSharding(mesh, resolve_spec(mesh, s)), spec_tree)


def dp(mesh, *rest) -> P:
    return cm.dp_spec(*rest, mesh=mesh)


def data_axis_size(mesh) -> int:
    return cm.data_size(mesh)


class _Abstract(TorchDispatchMode):
    """Every op on the ``meta`` device, random ops without a generator."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = dict(kwargs or {})
        if "device" in kwargs:
            kwargs["device"] = torch.device("meta")
        if "generator" in kwargs:
            kwargs["generator"] = None
        return func(*args, **kwargs)


def abstract_params(init_fn, *args) -> Any:
    """``init_fn(*args)``'s tree as ``meta`` tensors (the reference's
    ``jax.eval_shape``): same shapes and dtypes, nothing drawn."""
    with _Abstract():
        return init_fn(*args)


def sds(shape, dtype=torch.float32) -> torch.Tensor:
    """An abstract input: a ``meta`` tensor of that shape and dtype."""
    return torch.empty(tuple(shape), dtype=dtype, device="meta")


def value_and_grad(loss_fn, params, batch):
    """``(loss, grads)`` of the scalar ``loss_fn(params, batch)``: the
    gradient tree has ``params``' structure and dtypes.  The parameters are
    differentiated through detached aliases, so the caller's tensors keep
    their ``requires_grad`` and an in-place update of them reaches the next
    call."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    loss = loss_fn(tree.unflatten_like(params, leaves), batch)
    grads = [_placed_like(g, p)
             for g, p in zip(torch.autograd.grad(loss, leaves), leaves)]
    return loss.detach(), tree.unflatten_like(params, grads)


def _placed_like(g, p):
    """A ``DTensor`` gradient on its parameter's placements (a pending sum
    reduced), as the reference's gradients take their parameters'
    shardings."""
    from torch.distributed.tensor import DTensor

    if isinstance(g, DTensor) and isinstance(p, DTensor) \
            and g.placements != p.placements:
        return g.redistribute(p.device_mesh, p.placements)
    return g


def make_train_step(loss_fn, ocfg: adamw.AdamWConfig, microbatches: int = 1,
                    grad_specs=None):
    """``step(params, opt_state, batch) -> (params, opt_state, {"loss",
    "lr", "grad_norm"})``.  With ``microbatches > 1`` the batch's leading
    dim is split into that many microbatches, one after another, and their
    gradients and losses are summed in float32 and divided by the count, so
    the activation peak is one microbatch's.  With one, the gradients go to
    ``adamw.update`` in their own dtype: it casts them to float32 a leaf at
    a time, which gives the reference's float32 cast of the whole tree.

    ``grad_specs``: a tree of specs like the parameters.  When the
    gradients are ``DTensor``s (inside ``common.use_mesh``) the float32
    gradients (the accumulator, or the one microbatch's gradients cast to
    float32) are sharded to them, the reference's ZeRO-2; plain gradients
    ignore them, as the reference's ``shard`` is the identity without a
    mesh."""
    specs = None if grad_specs is None else cm.spec_leaves(grad_specs)

    def zero2(grads) -> bool:
        return specs is not None and cm.is_dtensor(grads[0])

    def step(params, opt_state, batch):
        if microbatches > 1:
            split = {k: _microbatches(v, microbatches)
                     for k, v in batch.items()}
            acc, loss = None, None
            for i in range(microbatches):
                l, g = value_and_grad(loss_fn, params,
                                      {k: v[i] for k, v in split.items()})
                g = tree.leaves(g)
                if acc is None:
                    acc = [torch.zeros_like(x, dtype=torch.float32)
                           for x in g]
                    if zero2(acc):
                        acc = [cm.shard(a, s) for a, s in zip(acc, specs)]
                    loss = torch.zeros_like(l, dtype=torch.float32)
                for a, b in zip(acc, g):
                    a.add_(b)
                loss = loss + l
                del g
            grads = tree.unflatten_like(
                params, [a.div_(microbatches) for a in acc])
            loss = loss / microbatches
        else:
            loss, grads = value_and_grad(loss_fn, params, batch)
            if zero2(tree.leaves(grads)):
                grads = tree.unflatten_like(params, [
                    cm.shard(g.float(), s)
                    for g, s in zip(tree.leaves(grads), specs)])
        params, opt_state, om = adamw.update(ocfg, params, opt_state, grads)
        return params, opt_state, {"loss": loss, **om}

    return step


def _microbatches(v, n: int):
    """``v`` (B, ...) as (n, B / n, ...): microbatch i is rows [i B/n, (i +
    1) B/n), as the reference splits them.  A ``DTensor`` is gathered
    whole, split, and placed again with the batch's sharding on each
    microbatch's rows (its local split would change which rows meet in a
    microbatch, and with them an MoE layer's routing)."""
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape = (n, v.shape[0] // n) + tuple(v.shape[1:])
    if not isinstance(v, DTensor):
        return v.reshape(shape)
    mesh = v.device_mesh
    whole = v.redistribute(mesh, [Replicate()] * mesh.ndim).reshape(shape)
    return whole.redistribute(mesh, [Shard(p.dim + 1) if isinstance(p, Shard)
                                     else p for p in v.placements])


def train_state_shardings(mesh, cfg_specs, params_abs):
    """(param shardings, ZeRO opt-state shardings) for a param spec tree."""
    psh = shardings(mesh, cfg_specs)
    osp = adamw.zero_specs(cfg_specs, params_abs,
                           data_axes=cm.dp_axes(mesh),
                           data_size=data_axis_size(mesh))
    return psh, shardings(mesh, osp)
