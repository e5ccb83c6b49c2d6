"""Row-sharded embedding tables (port of the JAX package's
``models/recsys/embedding.py``).

* ``take_baseline`` — the plain gather on the whole table (the reference's
  pjit baseline, whose sharding constraint is the identity here);
* ``sharded_lookup`` — the table's rows in V / p blocks over the mesh axis
  ``axis``: each rank gathers the ids in its own block from that block
  alone (a masked gather), and ONE sum all-reduce over the axis
  (``core.distributed.all_reduce``, counted in ``COLLECTIVES``) combines
  them.  Every id has exactly one owner, so the sum is the take's value
  exactly (the others add zeros).

The port's mesh is SPMD: every rank calls with the same ``table`` and
``ids`` and gets the whole result, as the reference's ``shard_map`` with a
replicated output gives every device.
"""

from __future__ import annotations

import torch

from repro_torch.core import distributed as D


def take_baseline(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]``: (*ids.shape, D)."""
    return table[ids.long()]


def _has_axis(mesh, axis: str) -> bool:
    return mesh is not None and axis in (mesh.mesh_dim_names or ())


def sharded_lookup(table: torch.Tensor, ids: torch.Tensor, mesh=None,
                   axis: str = "model") -> torch.Tensor:
    """``table[ids]`` through a row-sharded table over ``mesh``'s ``axis``
    (a ``DeviceMesh``); the plain take with no mesh or a mesh without that
    axis.  Raises ``ValueError`` when V is not a multiple of the axis
    size."""
    if not _has_axis(mesh, axis):
        return take_baseline(table, ids)
    p = D.axis_size(mesh, axis)
    V = table.shape[0]
    if V % p:
        raise ValueError(f"vocab rows V={V} must be divisible by the "
                         f"{p}-way '{axis}' mesh axis for row sharding")
    rows = V // p
    lo = D.axis_index(mesh, axis) * rows
    block = table[lo:lo + rows]
    ids = ids.long()
    vals = block[(ids - lo).clamp(0, rows - 1)]
    owned = (ids >= lo) & (ids < lo + rows)
    vals = torch.where(owned[..., None], vals, torch.zeros_like(vals))
    return D.all_reduce(vals, "sum", D.axis_group(mesh, axis))
