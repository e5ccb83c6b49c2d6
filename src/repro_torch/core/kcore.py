"""k-core decomposition by bulk vertex peeling (port of ``repro.core.kcore``):
the structure the paper's Table 6 sets against the k_max-truss (a k-truss
is a (k-1)-core, not the other way round).

The reference runs the peel as one jitted ``lax.while_loop``; here it is a
host loop over device tensors with one ``host_read`` a round.  Each round
either removes every alive vertex of degree <= k (the degrees of the alive
endpoints of the edges that die drop by ``index_add_``) or, when there is
none, jumps k to ``max(k + 1, min alive degree)``.  It is a loop of
PyTorch ops, not a kernel: the reference has no Pallas kernel here.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core import graph as glib
from repro_torch.device import host_read, resolve_device

_BIG = np.iinfo(np.int32).max // 2


def _core_peel(eu, ev, deg0, alive0) -> torch.Tensor:
    """Core number of every vertex (int32), by bulk-synchronous peeling
    over the static edge list ``(eu, ev)`` (int64 tensors on one device)."""
    n = deg0.shape[0]
    alive, deg = alive0, deg0
    core = torch.zeros(n, dtype=torch.int32, device=deg0.device)
    k = 0
    while True:
        rm = alive & (deg <= k)
        any_alive, any_rm, min_deg = host_read(
            alive.any(), rm.any(), torch.where(alive, deg, _BIG).min())
        if not any_alive:
            break
        if not any_rm:
            k = max(k + 1, min_deg)
            continue
        alive2 = alive & ~rm
        died = (alive[eu] & alive[ev]) & ~(alive2[eu] & alive2[ev])
        dec = torch.zeros(n, dtype=torch.int32, device=deg0.device)
        dec.index_add_(0, eu, (died & alive2[eu]).to(torch.int32))
        dec.index_add_(0, ev, (died & alive2[ev]).to(torch.int32))
        core = torch.where(rm, k, core)
        alive, deg = alive2, deg - dec
    return core


def core_decompose(n: int, edges: np.ndarray, *, device=None) -> np.ndarray:
    """Core number of every vertex, (n,) int64."""
    dev = resolve_device(device)
    edges = glib.canonical_edges(edges, n)
    deg = glib.degrees(n, edges).astype(np.int32)
    if len(edges) == 0:
        return np.zeros(n, np.int64)
    e = torch.as_tensor(edges.astype(np.int64), device=dev)
    deg_d = torch.as_tensor(deg, device=dev)
    core = _core_peel(e[:, 0], e[:, 1], deg_d, deg_d > 0)
    return core.cpu().numpy().astype(np.int64)


def cmax_core(n: int, edges: np.ndarray, *,
              device=None) -> tuple[int, np.ndarray]:
    """The c_max-core: ``(c_max, edge list of the maximum core)``."""
    edges = glib.canonical_edges(edges, n)
    core = core_decompose(n, edges, device=device)
    cmax = int(core.max()) if n else 0
    keep = (core[edges[:, 0]] >= cmax) & (core[edges[:, 1]] >= cmax)
    return cmax, edges[keep]
