"""Shared model building blocks on tensors: initialisation from an explicit
``torch.Generator``, RMS and layer norm, SwiGLU, rotary embeddings, the
token-mean cross-entropy, the binary cross-entropy on logits and the
all-finite check of a training step; and the mesh helpers.

Mesh helpers: ``P`` is the port's PartitionSpec, one entry per tensor dim
(None, a mesh axis name, or a tuple of names; dims past the last entry are
replicated).  The port has no ambient mesh of its own, so ``use_mesh`` is
the counterpart of the reference's ``with mesh:``: the dry run and the
cell runs enter it with a ``DeviceMesh``.  Inside it, ``shard(x, spec)``
redistributes a ``DTensor`` to the spec's placements (axes absent from the
mesh dropped, as the reference's ``shard`` drops them); outside it, and on
a plain tensor, ``shard`` is the identity, so every single-device path is
unchanged.  ``dp_spec`` puts the batch dim over ``("pod", "data")``, the
data axes the active mesh has.
"""

from __future__ import annotations

import contextlib
import contextvars
import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.tree import leaves


# ---------------------------------------------------------------------------
# Mesh helpers
# ---------------------------------------------------------------------------

class P(tuple):
    """A PartitionSpec: ``P(None, ("pod", "data"), "model")``.  A tuple
    entry of one axis is that axis, as JAX's PartitionSpec normalises it."""

    def __new__(cls, *entries):
        return super().__new__(cls, (
            e[0] if isinstance(e, (tuple, list)) and len(e) == 1
            else tuple(e) if isinstance(e, list) else e for e in entries))

    def __repr__(self) -> str:
        return "P" + tuple.__repr__(self)


_MESH = contextvars.ContextVar("repro_torch_mesh", default=None)


@contextlib.contextmanager
def use_mesh(mesh):
    """Make ``mesh`` (a ``DeviceMesh`` with named dims) the active mesh
    inside the block."""
    token = _MESH.set(mesh)
    try:
        yield mesh
    finally:
        _MESH.reset(token)


def current_mesh():
    """The mesh of the innermost ``use_mesh`` block, else None."""
    return _MESH.get()


def is_dtensor(x) -> bool:
    """``x`` is a ``DTensor`` (a tensor placed on a mesh): the model code
    takes a mesh variant on such a tensor and its one plain path on any
    other."""
    from torch.distributed.tensor import DTensor

    return isinstance(x, DTensor)


def mesh_axis_names() -> tuple:
    mesh = current_mesh()
    return tuple(mesh.mesh_dim_names) if mesh is not None else ()


def mesh_axis_size(name: str) -> int:
    """Ranks along ``name`` on the active mesh (1 without it)."""
    mesh = current_mesh()
    if mesh is None or name not in mesh.mesh_dim_names:
        return 1
    return mesh.size(mesh.mesh_dim_names.index(name))


def dp_axes(mesh=None) -> tuple:
    """Data-parallel axes present on ``mesh`` (None: the active mesh),
    pod-major."""
    names = mesh_axis_names() if mesh is None else mesh.mesh_dim_names
    return tuple(a for a in ("pod", "data") if a in names)


def dp_spec(*rest, mesh=None) -> P:
    """P(dp_axes(mesh), *rest): the batch dim over every data axis."""
    axes = dp_axes(mesh)
    lead = axes if len(axes) > 1 else (axes[0] if axes else None)
    return P(lead, *rest)


def data_size(mesh=None) -> int:
    """Ranks over the data axes of ``mesh`` (None: the active mesh)."""
    mesh = current_mesh() if mesh is None else mesh
    size = 1
    for a in dp_axes(mesh) if mesh is not None else ():
        size *= mesh.size(mesh.mesh_dim_names.index(a))
    return size


def resolve(names, spec) -> P:
    """``spec`` with the axes that ``names`` lacks dropped (a tuple entry
    keeps the axes it has, None if none)."""
    names = set(names)

    def fix(entry):
        if entry is None:
            return None
        if isinstance(entry, (tuple, list)):
            kept = tuple(a for a in entry if a in names)
            return kept if kept else None
        return entry if entry in names else None

    return P(*(fix(e) for e in spec))


def placements(mesh, spec) -> list:
    """The ``DTensor`` placements of ``spec`` on ``mesh``: for each mesh
    dim, ``Shard(d)`` of the tensor dim whose entry names it, else
    ``Replicate()``.  Mesh dims in mesh order shard a tensor dim named by
    several (row-major, as the reference's tuple entries in mesh order)."""
    from torch.distributed.tensor import Replicate, Shard

    spec = resolve(mesh.mesh_dim_names, spec)
    out = []
    for axis in mesh.mesh_dim_names:
        dims = [d for d, e in enumerate(spec)
                if e == axis or (isinstance(e, tuple) and axis in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def replicated(fn, *args):
    """``fn(*args)``; under a mesh with ``DTensor`` arguments, on their
    replicated local values, the result (a tensor or a tuple of them)
    replicated ``DTensor``s (around ops that ``DTensor`` has no sharding
    rule for, as XLA's partitioner gathers what it cannot partition)."""
    mesh = current_mesh()
    if mesh is None:
        return fn(*args)
    from torch.distributed.tensor import DTensor, Replicate

    if not any(isinstance(a, DTensor) for a in args):
        return fn(*args)
    rep = [Replicate()] * mesh.ndim
    local = [a.redistribute(mesh, rep).to_local() if isinstance(a, DTensor)
             else a for a in args]
    out = fn(*local)
    if isinstance(out, tuple):
        return tuple(DTensor.from_local(o, mesh, rep, run_check=False)
                     for o in out)
    return DTensor.from_local(out, mesh, rep, run_check=False)


def local_grad(pl) -> list:
    """The gradient placements of a replicated input that each rank uses
    on its own rows (the rows placed ``pl``): a pending sum over the mesh
    dims that split the rows, replicated over the others."""
    from torch.distributed.tensor import Partial, Replicate, Shard

    return [Partial() if isinstance(p, Shard) else Replicate() for p in pl]


def edge_sum(fn, x, seg):
    """``fn(x, seg)``, a scatter-sum of rows into segments; under a mesh
    with a ``DTensor`` ``x``, each rank scatters its own rows (the rows
    over every mesh axis) and the result is a pending sum over the mesh
    (``Partial``), the reference partitioner's psum."""
    mesh = current_mesh()
    from torch.distributed.tensor import DTensor

    if mesh is None or not isinstance(x, DTensor):
        return fn(x, seg)
    from torch.distributed.tensor import Partial, Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * mesh.ndim
    if not isinstance(seg, DTensor):
        seg = DTensor.from_local(seg, mesh, rep, run_check=False)
    rows = placements(mesh, P(tuple(mesh.mesh_dim_names)))
    return local_map(fn, out_placements=[Partial()] * mesh.ndim,
                     in_placements=(rows, rows), device_mesh=mesh,
                     redistribute_inputs=True)(x, seg)


def gather(x, idx):
    """``x[idx]``.  Under a mesh with a ``DTensor`` index (edge rows, dim 0
    sharded), each rank gathers its own index rows from ``x`` replicated
    (``local_map``): the result is sharded like the index."""
    mesh = current_mesh()
    from torch.distributed.tensor import DTensor

    if mesh is None or not isinstance(idx, DTensor):
        return x[idx]
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * mesh.ndim
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, rep, run_check=False)
    rows = list(idx.placements)
    return local_map(lambda x, i: x[i], out_placements=rows,
                     in_placements=(rep, rows),
                     in_grad_placements=(local_grad(rows), rows),
                     device_mesh=mesh, redistribute_inputs=True)(x, idx)


def rowwise(fn, *args, n_out: int = 1, replicated=()):
    """``fn(*args)`` of row arrays (dim 0 the rows).  Under a mesh with
    ``DTensor`` arguments, each rank runs ``fn`` on its own rows
    (``local_map``, every output placed like the first ``DTensor``
    argument); the arguments at the indices in ``replicated`` (node state,
    parameters) are replicated to every rank."""
    mesh = current_mesh()
    from torch.distributed.tensor import DTensor

    rows = next((list(a.placements) for i, a in enumerate(args)
                 if isinstance(a, DTensor) and i not in replicated), None)
    if mesh is None or rows is None:
        return fn(*args)
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * mesh.ndim
    args = [DTensor.from_local(a, mesh, rep, run_check=False)
            if i in replicated and isinstance(a, torch.Tensor)
            and not isinstance(a, DTensor) else a
            for i, a in enumerate(args)]
    in_pl = tuple(rep if i in replicated else
                  (list(a.placements) if isinstance(a, DTensor) else None)
                  for i, a in enumerate(args))
    grad_pl = tuple(local_grad(rows) if i in replicated else pl
                    for i, pl in enumerate(in_pl))
    return local_map(fn, out_placements=rows if n_out == 1
                     else (rows,) * n_out, in_placements=in_pl,
                     in_grad_placements=grad_pl, device_mesh=mesh,
                     redistribute_inputs=True)(*args)


def take(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` (ids of any integer dtype).  Under a mesh with a
    ``DTensor`` table each rank gathers from its own row block
    (``local_map``): a masked gather whose pending sum over the table's row
    axis is the take, the reference's ``sharded_lookup`` (ids sharded over
    that axis are replicated first)."""
    mesh = current_mesh()
    from torch.distributed.tensor import DTensor

    if mesh is None or not isinstance(table, DTensor):
        return table[ids.long()]
    from torch.distributed.tensor import Partial, Replicate, Shard
    from torch.distributed.tensor.experimental import local_map

    rep = [Replicate()] * mesh.ndim
    if not isinstance(ids, DTensor):
        ids = DTensor.from_local(ids, mesh, rep, run_check=False)
    rows = [i for i, p in enumerate(table.placements) if isinstance(p, Shard)]
    if len(rows) > 1 or any(table.placements[i].dim for i in rows):
        raise ValueError(f"a table's rows over one mesh axis, got "
                         f"{table.placements}")
    ipl = [Replicate() if i in rows else p
           for i, p in enumerate(ids.placements)]
    opl = [Partial() if i in rows else p for i, p in enumerate(ipl)]
    # a row block is torch.chunk's: ceil(V / p) rows, the last ones fewer
    # (or none)
    chunk = -(-table.shape[0] // mesh.size(rows[0])) if rows else 0

    def local(t, i):
        i = i.long()
        if not rows:
            return t[i]
        n = t.shape[0]
        if n == 0:
            return t.new_zeros(tuple(i.shape) + tuple(t.shape[1:]))
        lo = mesh.get_local_rank(rows[0]) * chunk
        vals = t[(i - lo).clamp(0, n - 1)]
        return torch.where(((i >= lo) & (i < lo + n))[..., None], vals,
                           torch.zeros_like(vals))

    # the table's gradient: its own rows, a pending sum over the mesh dims
    # that split the ids
    tgrad = [p if i in rows else (Partial() if isinstance(ipl[i], Shard)
                                  else Replicate())
             for i, p in enumerate(table.placements)]
    return local_map(local, out_placements=opl,
                     in_placements=(list(table.placements), ipl),
                     in_grad_placements=(tgrad, ipl),
                     device_mesh=mesh, redistribute_inputs=True)(table, ids)


def batch_spec(batch: int, *rest) -> P:
    """``dp_spec(*rest)`` when the data axes divide ``batch``, else the
    batch replicated."""
    return dp_spec(*rest) if batch % data_size() == 0 else P(None, *rest)


def sharded_zeros(shape, dtype, device, spec):
    """Zeros of ``shape`` as a ``DTensor`` placed by ``spec`` on the active
    mesh: this rank allocates its own shard, on ``device``."""
    from torch.distributed.tensor import DTensor
    from torch.distributed.tensor._utils import (
        compute_local_shape_and_global_offset)

    mesh = current_mesh()
    pl = placements(mesh, spec)
    local, _ = compute_local_shape_and_global_offset(shape, mesh, pl)
    return DTensor.from_local(torch.zeros(local, dtype=dtype, device=device),
                              mesh, pl, run_check=False, shape=shape,
                              stride=torch.empty(shape, device="meta")
                              .stride())


def spec_leaves(specs) -> list:
    """The specs of a tree of specs (dicts, lists, tuples; a ``P`` is a
    leaf), in ``tree.leaves``' walk order (dict keys sorted)."""
    if isinstance(specs, P) or specs is None:
        return [specs]
    if isinstance(specs, dict):
        return [x for k in sorted(specs) for x in spec_leaves(specs[k])]
    return [x for v in specs for x in spec_leaves(v)]


def map_specs(fn, specs, *trees):
    """``fn(spec, *leaves)`` over a tree of specs and trees of its shape."""
    if isinstance(specs, P):
        return fn(specs, *trees)
    if isinstance(specs, dict):
        return {k: map_specs(fn, specs[k], *(t[k] for t in trees))
                for k in specs}
    return type(specs)(map_specs(fn, s, *ts)
                       for s, *ts in zip(specs, *trees))


def shard(x, spec):
    """``x`` redistributed to ``spec`` when a mesh is active and ``x`` is
    a ``DTensor``; else ``x`` itself."""
    mesh = current_mesh()
    if mesh is None:
        return x
    from torch.distributed.tensor import DTensor

    if not isinstance(x, DTensor):
        return x
    return x.redistribute(mesh, placements(mesh, spec))


def dense_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (at +-2 std) fan-in init (fan-in: ``shape[-2]``),
    drawn in float32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x / math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + weight``; x's dtype out."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim in float32 (biased variance); x's dtype
    out."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu in float32, cast to the gate's dtype, times ``up``."""
    return F.silu(gate.float()).to(gate.dtype) * up


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D), rotated on the last dim by halves (not
    interleaved); positions: (..., S)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                    # (D/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32; logits (..., V), labels (...)
    int.  With ``mask``, the masked mean over ``max(mask.sum(), 1)``.
    On ``DTensor`` logits the label's logit is a masked sum over V (the
    vocab may be sharded; the card's torch has no ``DTensor`` rule for
    this ``gather``)."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    if is_dtensor(logits):
        vocab = torch.arange(logits.shape[-1], device=logits.device)
        ll = torch.where(vocab == labels.long()[..., None], logits,
                         0.0).sum(-1)
    else:
        ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of ``logits`` against 0/1 ``labels``, in
    float32, in the overflow-free form ``max(z, 0) - z y + log1p(e^-|z|)``.
    At z = 0 the gradient takes the reference's one-sided derivatives (max:
    1/2 to each side; |z|: 1), so it equals JAX's there too."""
    z, y = logits.float(), labels.float()
    abs_z = torch.where(z >= 0, z, -z)
    return (torch.maximum(z, torch.zeros_like(z)) - z * y
            + torch.log1p(torch.exp(-abs_z))).mean()


def finite_check(tree) -> torch.Tensor:
    """A bool tensor: every floating tensor of a tree of dicts, lists and
    tuples (on one device) is finite; True when there is none."""
    oks = [torch.isfinite(x).all() for x in leaves(tree)
           if isinstance(x, torch.Tensor) and x.is_floating_point()]
    return torch.stack(oks).all() if oks else torch.tensor(True)
