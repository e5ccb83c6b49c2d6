"""Production meshes (port of the JAX package's ``launch/mesh.py``).

Single pod: (data=16, model=16) = 256 devices.  Multi-pod: (pod=2,
data=16, model=16) = 512: the "pod" axis carries only data parallelism.
The shapes and axis names are the reference's: the cells' edge padding
(``gnn_family._EDGE_PAD = 512``) and their specs assume them.

Each function builds a ``DeviceMesh`` over the process group that exists
(``torch.distributed`` initialised by the caller): the real ranks of a
cluster, or, for the dry run, a fake group of 256 or 512 ranks.  The
device type follows the group's backend (NCCL: "cuda", else "cpu").
Nothing here runs when the module is imported.
"""

from __future__ import annotations

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _device_type() -> str:
    return "cuda" if dist.get_backend() == "nccl" else "cpu"


def make_production_mesh(*, multi_pod: bool = False):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return init_device_mesh(_device_type(), shape, mesh_dim_names=axes)


def make_host_mesh(n: int | None = None, axes=("data", "model")):
    """A mesh over ``n`` ranks (None: the whole group), the reference's
    factoring: a 2-D mesh takes the largest power-of-two split d with
    d * d < n for its first axis."""
    if n is not None and n <= 0:
        raise ValueError(f"mesh device count must be positive or None "
                         f"(= every rank of the group), got {n!r}")
    total = dist.get_world_size() if n is None else n
    nd = total
    if len(axes) == 1:
        return init_device_mesh(_device_type(), (nd,), mesh_dim_names=axes)
    d = 1
    while nd % 2 == 0 and d * d < nd:
        d *= 2
        nd //= 2
    return init_device_mesh(_device_type(), (d, total // d),
                            mesh_dim_names=axes)
