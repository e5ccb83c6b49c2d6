"""Ring-scheduled full-graph message passing on ``torch.distributed`` (port
of the JAX package's ``models/gnn/distributed.py``).

The memory problem: EquiformerV2's node features on ogb_products are
(2.45 M, 49, 128) float32, about 61 GB; they must live sharded, and a
plain ``x[src]`` gather would need the whole array on every device.  The
ring:

* nodes are block-sharded over the flattened mesh axes (owner = the src
  block); every rank keeps the edges whose SOURCE it owns, bucketed by the
  destination block (``bucket_edges_by_owner``, on the host), so the
  feature gather is local;
* the per-block partial aggregations travel the ring (``ring_shift``),
  each rank adding its contribution for the block the accumulator is
  destined to; after P steps each rank holds the whole aggregation for its
  own block.  Peak memory: x_loc plus ONE rotating block; each rank sends
  (P - 1) / P of the message volume, the reduce-scatter bound.

Attention normalisation across ranks: per-edge weights are ``exp`` of the
soft-clipped logit, computed from source-side invariants; the ring carries
(numerator, denominator) and the owner divides: the plain path's segment
softmax of the clipped logits.

The port is SPMD, as ``shard_map`` is: each rank calls the loss with its
own shard of the batch (its W-row node block and its (1, P, Eb) owner slab
of the buckets; a ``DTensor`` sharded on dim 0 is taken by its local
shard) and the whole parameters.  The loss's sum over ranks passes its
cotangent through unchanged, so each rank's parameter gradients are its
own partial sums; they are summed over the ring's ranks once per step (one
all-reduce a leaf in the backward), and every rank holds the whole
gradient, as the reference's replicated parameters get theirs.
"""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.core import distributed as D
from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.models import (EquiformerV2Config, _eqv2_gate,
                                           _geometry, _so2_conv)


# ---------------------------------------------------------------------------
# Host prep: owner-bucketed edges
# ---------------------------------------------------------------------------

def bucket_edges_by_owner(
    n_pad: int, edge_index: np.ndarray, positions: np.ndarray,
    n_devices: int, pad_factor: float = 2.0,
) -> dict:
    """Bucket directed edges by (owner = src block, dst block).

    Returns (P, P, Eb) arrays: src_loc, dst_loc (block-local ids), edge_mask,
    and dst_pos (P, P, Eb, 3); ``overflow`` counts the edges past Eb that
    were dropped.  n_pad must be divisible by n_devices.
    """
    Pn = n_devices
    if n_pad % Pn:
        raise ValueError(f"n_pad={n_pad} must be divisible by "
                         f"n_devices={Pn}; pad the vertex count first")
    W = n_pad // Pn
    src = edge_index[:, 0].astype(np.int64)
    dst = edge_index[:, 1].astype(np.int64)
    own = src // W
    blk = dst // W
    counts = np.zeros((Pn, Pn), np.int64)
    np.add.at(counts, (own, blk), 1)
    Eb = max(1, int(counts.max()),
             int(np.ceil(pad_factor * len(src) / (Pn * Pn))))
    key = own * Pn + blk
    order = np.argsort(key, kind="stable")
    ssrc, sdst, skey = src[order], dst[order], key[order]
    slot = np.arange(len(skey)) - np.searchsorted(skey, skey, side="left")
    keep = slot < Eb
    src_loc = np.zeros((Pn, Pn, Eb), np.int32)
    dst_loc = np.zeros((Pn, Pn, Eb), np.int32)
    mask = np.zeros((Pn, Pn, Eb), bool)
    dst_pos = np.zeros((Pn, Pn, Eb, 3), np.float32)
    o, b, s_ = own[order][keep], blk[order][keep], slot[keep]
    src_loc[o, b, s_] = (ssrc[keep] - o * W).astype(np.int32)
    dst_loc[o, b, s_] = (sdst[keep] - b * W).astype(np.int32)
    mask[o, b, s_] = True
    dst_pos[o, b, s_] = positions[np.minimum(sdst[keep], len(positions) - 1)]
    return {"src_loc": src_loc, "dst_loc": dst_loc, "edge_mask": mask,
            "dst_pos": dst_pos, "overflow": int((~keep).sum())}


def pad_nodes(arr: np.ndarray, n_pad: int) -> np.ndarray:
    out = np.zeros((n_pad,) + arr.shape[1:], arr.dtype)
    out[: len(arr)] = arr
    return out


# ---------------------------------------------------------------------------
# The ring group and the collectives with gradients
# ---------------------------------------------------------------------------

def ring_axes(mesh, axes=("data", "model")) -> tuple:
    return tuple(a for a in axes if a in mesh.mesh_dim_names)


def ring_group(mesh, axes=("data", "model")) -> tuple:
    """(group, P, this rank's index) of the flattened ring axes."""
    ax = ring_axes(mesh, axes)
    return D.axis_group(mesh, ax), D.axis_size(mesh, ax), D.axis_index(
        mesh, ax)


def _shift(acc: dict, group, step: int) -> dict:
    """Every tensor of ``acc`` (one dtype) moved ``step`` ranks on, in one
    ring exchange."""
    keys = sorted(acc)
    flat = D.ring_shift(torch.cat([acc[k].reshape(-1) for k in keys]),
                        group, step)
    out, at = {}, 0
    for k in keys:
        n = acc[k].numel()
        out[k] = flat[at:at + n].view(acc[k].shape)
        at += n
    return out


class _Psum(torch.autograd.Function):
    """The sum over the group; the cotangent passes through unchanged (each
    rank's gradients stay its partial sums)."""

    @staticmethod
    def forward(ctx, x, group):
        return D.all_reduce(x.clone(), "sum", group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _SumGrads(torch.autograd.Function):
    """The identity; its gradient summed over the group."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return D.all_reduce(g.clone(), "sum", ctx.group), None


def _local(x):
    from torch.distributed.tensor import DTensor

    return x.to_local() if isinstance(x, DTensor) else x


def _replicated(params, group):
    """The parameters as this rank's tensors whose gradients are summed
    over ``group`` in the backward."""
    return tree.map_leaves(
        lambda p: _SumGrads.apply(_local(p), group), params)


# ---------------------------------------------------------------------------
# Ring reduce-scatter with fused compute
# ---------------------------------------------------------------------------

def ring_aggregate(contrib_fn: Callable, acc_init, group, axis_size: int,
                   index: int) -> dict:
    """After the ring, each rank holds  sum_rank contrib_fn(rank -> my
    block), a dict of tensors of one dtype.

    Schedule: the accumulator for block b starts at rank (b+1) mod P; at
    step j rank d adds its contribution for block (d-1-j) mod P, then the
    accumulators rotate +1.  After P add-rotate steps a final rotate(-1)
    lands block b's accumulator on rank b.  ``acc_init`` None starts from
    the first contribution (0 + a is a).
    """
    acc = acc_init
    for j in range(axis_size):
        add = contrib_fn((index - 1 - j) % axis_size)
        acc = _shift(add if acc is None else
                     {k: acc[k] + add[k] for k in acc}, group, 1)
    return _shift(acc, group, -1)


def make_ring_layer(contrib_fn: Callable, group, axis_size: int,
                    index: int):
    """The ring as a ``torch.autograd.Function``: O(1 block) memory in BOTH
    passes.

    ``contrib_fn(b, x, blk, pos, dpos, src, dst, emask) -> {"num", "den"}``,
    ``blk`` a tree of tensors.  Differentiating through the forward loop
    would keep every step's graph (P blocks); instead the backward runs its
    OWN ring: the transpose of a reduce-scatter is an all-gather, so the
    output cotangent blocks rotate the other way while each rank recomputes
    its step's contribution under ``enable_grad`` and applies that step's
    VJP (``torch.autograd.grad``), the 2x recompute of the reference.
    Gradients reach ``x``, ``blk``, ``pos`` and ``dpos`` where they
    require one.
    """
    Pn = axis_size

    class _Ring(torch.autograd.Function):
        @staticmethod
        def forward(ctx, blk_tree, x, pos, dpos, src, dst, emask, *leaves):
            blk = tree.unflatten_like(blk_tree, leaves)
            out = ring_aggregate(
                lambda b: contrib_fn(b, x, blk, pos, dpos, src, dst, emask),
                None, group, Pn, index)
            ctx.blk_tree = blk_tree
            ctx.keys = sorted(out)
            ctx.save_for_backward(x, pos, dpos, src, dst, emask, *leaves)
            return tuple(out[k] for k in ctx.keys)

        @staticmethod
        def backward(ctx, *g_out):
            x, pos, dpos, src, dst, emask, *leaves = ctx.saved_tensors
            need = ctx.needs_input_grad
            wrt = [(i, t) for i, t in ((1, x), (2, pos), (3, dpos))
                   if need[i]] + [(7 + i, t) for i, t in enumerate(leaves)
                                  if need[7 + i]]
            grads = [torch.zeros_like(t) for _, t in wrt]
            gblk = dict(zip(ctx.keys, g_out))
            for j in range(Pn):
                b = (index + j) % Pn   # the block whose cotangent we hold
                with torch.enable_grad():
                    ins = {i: t.detach().requires_grad_(True) for i, t in wrt}
                    args = [ins.get(i, t) for i, t in
                            ((1, x), (2, pos), (3, dpos))]
                    lv = [ins.get(7 + i, t) for i, t in enumerate(leaves)]
                    out = contrib_fn(b, args[0],
                                     tree.unflatten_like(ctx.blk_tree, lv),
                                     args[1], args[2], src, dst, emask)
                    outs = [(out[k], gblk[k]) for k in ctx.keys
                            if out[k].requires_grad]
                    if outs and wrt:
                        step = torch.autograd.grad(
                            [o for o, _ in outs], [ins[i] for i, _ in wrt],
                            [g for _, g in outs], allow_unused=True)
                        for acc, s in zip(grads, step):
                            if s is not None:
                                acc.add_(s)
                gblk = _shift(gblk, group, -1)
            res = [None] * (7 + len(leaves))
            for (i, _), gr in zip(wrt, grads):
                res[i] = gr
            return tuple(res)

    def ring_layer(x, blk, pos, dpos, src, dst, emask):
        out = _Ring.apply(blk, x, pos, dpos, src, dst, emask,
                          *tree.leaves(blk))
        return dict(zip(sorted(("num", "den")), out))

    return ring_layer


# ---------------------------------------------------------------------------
# EquiformerV2 ring forward (node-sharded)
# ---------------------------------------------------------------------------

def eqv2_ring_loss(params, batch, cfg: EquiformerV2Config, mesh,
                   axes=("data", "model")):
    """Masked-MSE loss with node features sharded over the flattened axes.

    ``batch`` (this rank's shard): node_feat (W, F), positions (W, 3),
    targets (W,), node_mask (W,); src_loc / dst_loc / edge_mask (1, P, Eb)
    and dst_pos (1, P, Eb, 3), this rank's owner slab of
    ``bucket_edges_by_owner``.  The ring's payload is ``cfg.ring_dtype``
    ("f32" or "bf16"); the owner divides in float32.
    """
    group, Pn, my = ring_group(mesh, axes)
    S, C = cfg.n_sph, cfg.d_hidden
    hd = C // cfg.n_heads
    dt = torch.bfloat16 if cfg.ring_dtype == "bf16" else torch.float32
    b_ = {k: _local(v) for k, v in batch.items()}
    src_b, dst_b = b_["src_loc"][0].long(), b_["dst_loc"][0].long()
    emask_b, dpos_b = b_["edge_mask"][0], b_["dst_pos"][0]
    pos, node_mask = b_["positions"], b_["node_mask"]
    W = b_["node_feat"].shape[0]
    params = _replicated(params, group)

    def _contrib(b, x, blk, pos, dpos_b, src_b, dst_b, emask_b):
        s_l, d_l, msk = src_b[b], dst_b[b], emask_b[b]
        rbf, Dm = _geometry(dpos_b[b] - pos[s_l], cfg)
        xs = x[s_l]
        xr = torch.bmm(Dm, xs)
        radial = L.mlp(blk["rbf_mlp"], rbf)
        y = _so2_conv(xr, blk, radial, cfg)
        msg = torch.bmm(Dm.transpose(1, 2), y)
        logit = 10.0 * torch.tanh(
            L.mlp(blk["attn_mlp"], torch.cat([xs[:, 0], rbf], dim=-1)) / 10.0)
        w = torch.exp(logit) * msk[:, None]                  # (Eb, H)
        msg_h = (msg.reshape(-1, S, cfg.n_heads, hd)
                 * w[:, None, :, None]).reshape(-1, S * C)
        msg_h = torch.where(msk[:, None], msg_h, 0.0)
        return {"num": L.segment_sum(msg_h, d_l, W).to(dt),
                "den": L.segment_sum(w, d_l, W).to(dt)}

    ring_layer = make_ring_layer(_contrib, group, Pn, my)

    def layer(x, blk):
        agg = ring_layer(x, blk, pos, dpos_b, src_b, dst_b, emask_b)
        num = agg["num"].float().reshape(W, S, cfg.n_heads, hd)
        den = torch.clamp(agg["den"].float(), min=1e-9)[:, None, :, None]
        return x + _eqv2_gate((num / den).reshape(W, S, C), blk["gate_mlp"],
                              cfg)

    h0 = b_["node_feat"] @ params["embed"]
    x = torch.cat([h0[:, None], h0.new_zeros((W, S - 1, C))], dim=1)
    for blk in params["blocks"]:
        if torch.is_grad_enabled():
            x = checkpoint(layer, x, blk, use_reentrant=False)
        else:
            x = layer(x, blk)
    out = L.mlp(params["head"], x[:, 0])[:, 0]
    err = torch.square(out - b_["targets"]) * node_mask
    num = _Psum.apply(err.sum(), group)
    den = D.all_reduce(node_mask.sum().detach().clone(), "sum", group)
    return num / torch.clamp(den, min=1.0)


# ---------------------------------------------------------------------------
# GraphSAGE ring forward
# ---------------------------------------------------------------------------

def sage_ring_loss(params, batch, cfg, mesh, axes=("data", "model")):
    """GraphSAGE full-graph training with node-sharded features and the same
    owner-bucketed ring reduce-scatter as EquiformerV2 (the reference's
    replacement of its replicate-nodes, psum-per-layer baseline).

    ``batch`` (this rank's shard): node_feat (W, F), labels / label_mask
    (W,), src_loc / dst_loc / edge_mask (1, P, Eb).
    """
    group, Pn, my = ring_group(mesh, axes)
    b_ = {k: _local(v) for k, v in batch.items()}
    src_b, dst_b = b_["src_loc"][0].long(), b_["dst_loc"][0].long()
    emask_b = b_["edge_mask"][0]
    h = b_["node_feat"]
    W = h.shape[0]
    params = _replicated(params, group)

    def contrib(b, x, blk, pos, dpos, s_b, d_b, m_b):
        s_l, d_l, msk = s_b[b], d_b[b], m_b[b]
        rows = torch.where(msk[:, None], x[s_l], 0.0)
        return {"num": L.segment_sum(rows, d_l, W),
                "den": L.segment_sum(msk.float(), d_l, W)}

    zero3 = h.new_zeros((W, 3))
    zdpos = h.new_zeros(tuple(src_b.shape) + (3,))
    ring = make_ring_layer(contrib, group, Pn, my)
    for lp in params["layers"]:
        agg = ring(h, {}, zero3, zdpos, src_b, dst_b, emask_b)
        nbr = agg["num"] / torch.clamp(agg["den"], min=1.0)[:, None]
        h = F.relu(h @ lp["w_self"] + nbr @ lp["w_nbr"] + lp["b"])
    logits = (h @ params["head"]).float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, b_["labels"].long()[:, None])[:, 0]
    label_mask = b_["label_mask"]
    num = _Psum.apply(((lse - ll) * label_mask).sum(), group)
    den = D.all_reduce(label_mask.sum().detach().clone(), "sum", group)
    return num / torch.clamp(den, min=1.0)
