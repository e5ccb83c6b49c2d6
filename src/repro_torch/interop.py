"""State carried across from the JAX package.

The JAX package keeps its host state in numpy: a ``Graph``'s arrays, a
partition bucket's arrays, a model's parameter tree.  These functions read
such an object by its attribute or key names (duck typing: nothing of
``repro`` is imported) and build the port's own objects and device tensors,
so that a test can hand both packages the same graph, bucket or weights.
"""

from __future__ import annotations

import numpy as np
import torch

from repro_torch.core.graph import Graph
from repro_torch.core.partition import PartBucket
from repro_torch.device import resolve_device
from repro_torch.tree import map_leaves

_GRAPH_ARRAYS = ("edges", "deg", "rank", "src", "dst", "indptr", "nbrs",
                 "nbr_eid")
_BUCKET_ARRAYS = ("sup", "tris", "alive", "indptr", "tids", "edge_ids",
                  "internal", "part_of")
_BUCKET_INTS = ("cap_e", "cap_t", "n_parts", "n_real_lanes", "real_edges")


def graph(src) -> Graph:
    """The port's :class:`Graph` from a graph object with the reference's
    attributes (``n``, ``max_out_deg`` and the packed arrays)."""
    return Graph(n=int(src.n), max_out_deg=int(src.max_out_deg),
                 **{k: np.array(getattr(src, k)) for k in _GRAPH_ARRAYS})


def part_bucket(src) -> PartBucket:
    """The port's :class:`PartBucket` from a bucket with the reference's
    fields."""
    return PartBucket(**{k: int(getattr(src, k)) for k in _BUCKET_INTS},
                      **{k: np.array(getattr(src, k))
                         for k in _BUCKET_ARRAYS})


def bucket_tensors(bucket, device=None) -> dict:
    """The device inputs of the fused peel for one bucket: ``sup``,
    ``alive`` (B, cap_e) and ``tris`` (B, cap_t, 3), int32 on ``device``."""
    dev = resolve_device(device)
    return {k: torch.as_tensor(np.asarray(getattr(bucket, k)).astype(
        np.int32), device=dev) for k in ("sup", "alive", "tris")}


def _tensor(a, dev: torch.device) -> torch.Tensor:
    """An array (numpy, or anything ``np.asarray`` reads) as a tensor on
    ``dev``; bfloat16 arrays (numpy has no such type of its own) are carried
    bit for bit."""
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.int16).copy()).view(
            torch.bfloat16).to(dev)
    return torch.from_numpy(a.copy()).to(dev)


def lm_params(tree, device=None) -> dict:
    """The port's LM parameters from the JAX package's parameter tree
    (``repro.models.transformer.init_params`` layout): ``embed``,
    ``final_norm``, ``layers`` (stacked ``(L, ...)`` arrays) and ``lm_head``
    unless the embedding is tied.  Every array is carried by its key with
    its dtype and bits: a MoE layer's float32 ``router`` stays float32 and
    its bf16 experts (``we_*``, ``ws_*``) keep their bf16 bits."""
    dev = resolve_device(device)
    out = {"embed": _tensor(tree["embed"], dev),
           "final_norm": _tensor(tree["final_norm"], dev),
           "layers": {k: _tensor(a, dev) for k, a in tree["layers"].items()}}
    if "lm_head" in tree:
        out["lm_head"] = _tensor(tree["lm_head"], dev)
    return out


def param_tree(tree, device=None):
    """A DIN or GNN parameter tree (dicts, lists and ``(w, b)`` tuples of
    arrays, the layout of ``models.recsys.din`` and ``models.gnn``) as the
    same tree of tensors on ``device``, every array bit for bit."""
    dev = resolve_device(device)
    return map_leaves(lambda a: _tensor(a, dev), tree)


def adamw_state(tree, device=None) -> dict:
    """The port's AdamW state from the JAX package's
    (``repro.optim.adamw.init_state`` layout: ``{"step", "master", "m",
    "v"}``, each of the last three a tree like the parameters): the same
    tree of tensors on ``device``, every array bit for bit (``step`` an
    int32 0-dim tensor)."""
    dev = resolve_device(device)
    return map_leaves(lambda a: _tensor(a, dev),
                      {k: tree[k] for k in ("step", "master", "m", "v")})
