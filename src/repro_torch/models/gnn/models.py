"""The four GNN archs (port of the JAX package's ``models/gnn/models.py``):
MeshGraphNet, GraphSAGE, GAT and EquiformerV2, each with its config, init,
forward and loss.

Batch format (static padded shapes, tensors on one device):
``node_feat`` (N, F) float32, ``edge_index`` (E, 2) int (src, dst; both
directions for an undirected graph), ``edge_mask`` (E,) bool,
``node_mask`` (N,) float, ``labels`` (N,) int (node tasks) or
``targets``, ``label_mask``, ``positions`` (N, 3) for the geometric models
and ``edge_feat`` (E, 4) for MeshGraphNet.

The reference's sharding annotations (``shard(..., dp_spec(...))``,
``_edge_spec``) are kept: the identity without a mesh, a ``DTensor``
redistribution under ``common.use_mesh`` (the dry run); under a mesh the
node state of GAT and EquiformerV2's gate runs replicated, the edges carry
the sharding, as the reference's node arrays replicate.  Its per-block
``jax.checkpoint`` is ``torch.utils.checkpoint`` (non-reentrant) under a
gradient; EquiformerV2's ``lax.scan`` over edge chunks is a loop whose
chunk outputs are concatenated, and its einsums are matmuls.  Parameters
come from an explicit ``torch.Generator``, on its device.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch import tree
from repro_torch.models import common as cm
from repro_torch.models.common import P, dp_spec, mesh_axis_names, shard
from repro_torch.models.gnn import layers as L
from repro_torch.models.gnn.wigner import rotation_to_z, wigner_stack


def _remat(fn, *args):
    """``fn(*args)``, under ``torch.utils.checkpoint`` when gradients are
    on (the reference's ``jax.checkpoint`` of each block)."""
    if torch.is_grad_enabled():
        return checkpoint(fn, *args, use_reentrant=False)
    return fn(*args)


def _edges(batch):
    ei = batch["edge_index"].long()
    return ei[:, 0], ei[:, 1]


# ---------------------------------------------------------------------------
# MeshGraphNet  [arXiv:2010.03409]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MeshGraphNetConfig:
    name: str = "meshgraphnet"
    n_layers: int = 15
    d_hidden: int = 128
    mlp_layers: int = 2
    d_node_in: int = 16
    d_edge_in: int = 4      # relative position (3) + norm (1)
    d_out: int = 3
    aggregator: str = "sum"
    edge_chunks: int = 1    # the reference's field (its forward ignores it)


def _mgn_mlp_dims(cfg, d_in):
    return [d_in] + [cfg.d_hidden] * cfg.mlp_layers


def mgn_init(gen: torch.Generator, cfg: MeshGraphNetConfig) -> dict:
    params = {
        "node_enc": L.mlp_init(gen, _mgn_mlp_dims(cfg, cfg.d_node_in)),
        "edge_enc": L.mlp_init(gen, _mgn_mlp_dims(cfg, cfg.d_edge_in)),
        "decoder": L.mlp_init(gen, [cfg.d_hidden] * cfg.mlp_layers
                              + [cfg.d_out]),
        "blocks": [],
    }
    for _ in range(cfg.n_layers):
        params["blocks"].append({
            "edge_mlp": L.mlp_init(gen, _mgn_mlp_dims(cfg, 3 * cfg.d_hidden)),
            "node_mlp": L.mlp_init(gen, _mgn_mlp_dims(cfg, 2 * cfg.d_hidden)),
        })
    return params


def _edge_spec():
    """Edge arrays (and MeshGraphNet's node state) over every mesh axis."""
    ax = tuple(a for a in ("pod", "data", "model") if a in mesh_axis_names())
    return P(ax if len(ax) > 1 else (ax[0] if ax else None), None)


def _mgn_block(h, e, blk, src, dst, emask, cfg):
    e = shard(e + L.mlp(blk["edge_mlp"], torch.cat(
        [e, cm.gather(h, src), cm.gather(h, dst)], dim=-1)), _edge_spec())
    agg = L.aggregate(e, dst, h.shape[0], agg=cfg.aggregator, mask=emask)
    h = shard(h + L.mlp(blk["node_mlp"], torch.cat([h, agg], dim=-1)),
              _edge_spec())
    return h, e


def mgn_forward(params, batch, cfg: MeshGraphNetConfig) -> torch.Tensor:
    src, dst = _edges(batch)
    emask = batch.get("edge_mask")
    h = shard(L.mlp(params["node_enc"], batch["node_feat"]), _edge_spec())
    e = shard(L.mlp(params["edge_enc"], batch["edge_feat"]), _edge_spec())
    for blk in params["blocks"]:
        h, e = _remat(_mgn_block, h, e, blk, src, dst, emask, cfg)
    return L.mlp(params["decoder"], h)


def mgn_loss(params, batch, cfg) -> torch.Tensor:
    out = mgn_forward(params, batch, cfg)
    err = torch.square(out - batch["targets"])
    if batch.get("node_mask") is not None:
        err = err * batch["node_mask"][:, None]
        return err.sum() / torch.clamp(batch["node_mask"].sum() * cfg.d_out,
                                       min=1.0)
    return err.mean()


# ---------------------------------------------------------------------------
# GraphSAGE  [arXiv:1706.02216]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GraphSAGEConfig:
    name: str = "graphsage"
    n_layers: int = 2
    d_hidden: int = 128
    d_in: int = 602
    n_classes: int = 41
    aggregator: str = "mean"


def sage_init(gen: torch.Generator, cfg: GraphSAGEConfig) -> dict:
    dims = [cfg.d_in] + [cfg.d_hidden] * cfg.n_layers
    layers = [{"w_self": cm.dense_init(gen, (dims[i], dims[i + 1])),
               "w_nbr": cm.dense_init(gen, (dims[i], dims[i + 1])),
               "b": torch.zeros((dims[i + 1],), device=gen.device)}
              for i in range(cfg.n_layers)]
    return {"layers": layers,
            "head": cm.dense_init(gen, (cfg.d_hidden, cfg.n_classes))}


def sage_forward(params, batch, cfg: GraphSAGEConfig) -> torch.Tensor:
    src, dst = _edges(batch)
    h = batch["node_feat"]
    for lp in params["layers"]:
        h = L.sage_layer(lp, h, src, dst, h.shape[0], batch.get("edge_mask"),
                         agg=cfg.aggregator)
        h = shard(h, dp_spec(None))
    return h @ params["head"]


def sage_loss(params, batch, cfg) -> torch.Tensor:
    return cm.cross_entropy(sage_forward(params, batch, cfg),
                            batch["labels"], batch.get("label_mask"))


# ---------------------------------------------------------------------------
# GAT  [arXiv:1710.10903]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GATConfig:
    name: str = "gat"
    n_layers: int = 2
    d_hidden: int = 8
    n_heads: int = 8
    d_in: int = 1433
    n_classes: int = 7


def _gat_layer_dims(cfg: GATConfig, i: int):
    final = i == cfg.n_layers - 1
    return cfg.n_heads, (cfg.n_classes if final else cfg.d_hidden), final


def gat_init(gen: torch.Generator, cfg: GATConfig) -> dict:
    layers, d_in = [], cfg.d_in
    for i in range(cfg.n_layers):
        heads, d_head, _ = _gat_layer_dims(cfg, i)
        layers.append({"w": cm.dense_init(gen, (d_in, heads * d_head)),
                       "a_src": cm.dense_init(gen, (heads, d_head)),
                       "a_dst": cm.dense_init(gen, (heads, d_head))})
        d_in = heads * d_head
    return {"layers": layers}


def gat_forward(params, batch, cfg: GATConfig) -> torch.Tensor:
    src, dst = _edges(batch)
    h = batch["node_feat"]
    for i, lp in enumerate(params["layers"]):
        heads, dh, final = _gat_layer_dims(cfg, i)
        h = L.gat_layer(lp, h, src, dst, h.shape[0], heads, dh,
                        batch.get("edge_mask"), final=final)
        h = shard(h, dp_spec(None))
    return h


def gat_loss(params, batch, cfg) -> torch.Tensor:
    return cm.cross_entropy(gat_forward(params, batch, cfg),
                            batch["labels"], batch.get("label_mask"))


# ---------------------------------------------------------------------------
# EquiformerV2 (eSCN SO(2) convolutions)  [arXiv:2306.12059]
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class EquiformerV2Config:
    name: str = "equiformer_v2"
    n_layers: int = 12
    d_hidden: int = 128      # channels per irrep slot
    l_max: int = 6
    m_max: int = 2
    n_heads: int = 8
    d_in: int = 16           # scalar input features
    d_out: int = 1           # graph/node scalar output
    n_rbf: int = 16
    edge_chunks: int = 1     # edge chunks a block (memory control)
    ring_dtype: str = "f32"  # the ring's payload: "f32" or "bf16"

    @property
    def n_sph(self) -> int:
        return (self.l_max + 1) ** 2


def _sph_index(l, m):
    return l * l + l + m


def _m_slots(cfg, m):
    """Irrep slots with degree >= m: the SO(2) conv operand rows for +m and
    for -m."""
    return ([_sph_index(l, m) for l in range(m, cfg.l_max + 1)],
            [_sph_index(l, -m) for l in range(m, cfg.l_max + 1)])


def eqv2_init(gen: torch.Generator, cfg: EquiformerV2Config) -> dict:
    C = cfg.d_hidden
    params = {"embed": cm.dense_init(gen, (cfg.d_in, C)),
              "head": L.mlp_init(gen, [C, C, cfg.d_out]),
              "blocks": []}
    for _ in range(cfg.n_layers):
        blk = {"rbf_mlp": L.mlp_init(gen, [cfg.n_rbf, C, cfg.m_max + 1]),
               "attn_mlp": L.mlp_init(gen, [C + cfg.n_rbf, C, cfg.n_heads]),
               "gate_mlp": L.mlp_init(gen, [C, C, cfg.l_max * C]),
               "so2": {}}
        for m in range(cfg.m_max + 1):
            n_l = cfg.l_max + 1 - m
            blk["so2"][f"wc_{m}"] = cm.dense_init(gen, (n_l, n_l, C, C))
            if m > 0:
                blk["so2"][f"ws_{m}"] = cm.dense_init(gen, (n_l, n_l, C, C))
        params["blocks"].append(blk)
    return params


def _mix(x, w):
    """The reference's ``einsum("eic,iocd->eod", x, w)`` as one matmul:
    x (E, n_l, C), w (n_l, n_l, C, C) -> (E, n_l, C)."""
    E, n_l, C = x.shape
    return (x.reshape(E, n_l * C)
            @ w.permute(0, 2, 1, 3).reshape(n_l * C, n_l * C)).reshape(
                E, n_l, C)


def _so2_conv(x_rot, blk, radial, cfg):
    """SO(2) m-mixing of x_rot (E, S, C), the features in each edge's frame.
    Every output slot is added once (the +m and -m slots are distinct and
    each m = 0 slot is written by m = 0 alone)."""
    slots, parts = [], []
    for m in range(cfg.m_max + 1):
        pos, neg = _m_slots(cfg, m)
        r = radial[:, None, m:m + 1]                          # (E, 1, 1)
        xp = x_rot[:, pos, :]                                 # (E, n_l, C)
        wc = blk["so2"][f"wc_{m}"]
        if m == 0:
            slots.append(pos)
            parts.append(_mix(xp, wc) * r)
            continue
        xn = x_rot[:, neg, :]
        ws = blk["so2"][f"ws_{m}"]
        slots += [pos, neg]
        parts.append((_mix(xp, wc) - _mix(xn, ws)) * r)
        parts.append((_mix(xp, ws) + _mix(xn, wc)) * r)
    idx = torch.tensor([s for ss in slots for s in ss], device=x_rot.device)
    return x_rot.new_zeros(x_rot.shape).index_add(1, idx, torch.cat(parts, 1))


def _rbf(dist, n_rbf, cutoff=5.0):
    centers = torch.linspace(0.0, cutoff, n_rbf, device=dist.device)
    return torch.exp(-((dist[:, None] - centers) ** 2) / (cutoff / n_rbf) ** 2)


def _edge_messages(x, blk, src, D, rbf, cfg):
    """Every edge's message (E, S, C) and attention logits (E, heads), in
    ``cfg.edge_chunks`` chunks of edges, one after another.  Under a mesh
    each rank runs its own edges, in chunks of them (``cm.rowwise``; the
    node state and the block's weights replicated)."""
    leaves = tree.leaves(blk)
    return cm.rowwise(
        lambda x, src, D, rbf, *w: _edge_messages_local(
            x, tree.unflatten_like(blk, w), src, D, rbf, cfg),
        x, src, D, rbf, *leaves, n_out=2,
        replicated=(0, *range(4, 4 + len(leaves))))


def _edge_messages_local(x, blk, src, D, rbf, cfg):
    E = src.shape[0]
    k = max(cfg.edge_chunks, 1)
    if E % k:
        raise ValueError(f"edge count E={E} must be divisible by "
                         f"cfg.edge_chunks={k}")
    Ec = E // k
    msgs, logits = [], []
    for c in range(k):
        sl = slice(c * Ec, (c + 1) * Ec)
        xs, Dc, rbfc = x[src[sl]], D[sl], rbf[sl]
        xr = torch.bmm(Dc, xs)                           # rotate to edge frame
        radial = L.mlp(blk["rbf_mlp"], rbfc)             # (Ec, m_max+1)
        y = _so2_conv(xr, blk, radial, cfg)
        msgs.append(torch.bmm(Dc.transpose(1, 2), y))    # rotate back (D^T)
        # invariant attention over the incoming edges, logits soft-clipped
        logit = L.mlp(blk["attn_mlp"], torch.cat([xs[:, 0], rbfc], dim=-1))
        logits.append(10.0 * torch.tanh(logit / 10.0))
    if k == 1:
        return msgs[0], logits[0]
    return torch.cat(msgs), torch.cat(logits)


def _eqv2_block(x, blk, src, dst, D, rbf, mask, cfg):
    n, S, C = x.shape
    E = src.shape[0]
    msg, logit = _edge_messages(x, blk, src, D, rbf, cfg)
    alpha = L.segment_softmax(logit, dst, n, mask=mask)      # (E, heads)
    hd = C // cfg.n_heads
    msg_h = msg.reshape(E, S, cfg.n_heads, hd) * alpha[:, None, :, None]
    agg = L.aggregate(msg_h.reshape(E, -1), dst, n, agg="sum", mask=mask)
    # node state replicated under a mesh (the edges carry the sharding)
    gate = blk["gate_mlp"]
    return x + cm.replicated(
        lambda agg, *w: _eqv2_gate(agg.reshape(n, S, C),
                                   tree.unflatten_like(gate, w), cfg),
        agg, *tree.leaves(gate))


def _eqv2_gate(agg, gate_mlp, cfg):
    """The gated nonlinearity: the scalars gate the l > 0 channels."""
    n, _, C = agg.shape
    gates = torch.sigmoid(L.mlp(gate_mlp, agg[:, 0]).reshape(n, cfg.l_max, C))
    gated = [F.silu(agg[:, 0:1])]
    for l in range(1, cfg.l_max + 1):
        gated.append(agg[:, l * l:(l + 1) * (l + 1)] * gates[:, None, l - 1])
    return torch.cat(gated, dim=1)


def _geometry(d_vec, cfg):
    """Each edge's radial basis (E, n_rbf) and rotation into its frame
    (E, S, S)."""
    dist = torch.linalg.norm(d_vec, dim=-1) + 1e-9
    return (_rbf(dist, cfg.n_rbf),
            wigner_stack(rotation_to_z(d_vec), cfg.l_max))


def eqv2_forward(params, batch, cfg: EquiformerV2Config) -> torch.Tensor:
    src, dst = _edges(batch)
    pos = batch["positions"]
    h0 = batch["node_feat"] @ params["embed"]
    n, S, C, E = h0.shape[0], cfg.n_sph, cfg.d_hidden, src.shape[0]
    x = torch.cat([h0[:, None], h0.new_zeros((n, S - 1, C))], dim=1)
    rbf, D = cm.rowwise(lambda dv: _geometry(dv, cfg), cm.gather(pos, dst)
                        - cm.gather(pos, src), n_out=2)
    mask = batch.get("edge_mask")
    if mask is None:
        mask = torch.ones(E, dtype=torch.bool, device=src.device)
    for blk in params["blocks"]:
        x = _remat(_eqv2_block, x, blk, src, dst, D, rbf, mask, cfg)
    return L.mlp(params["head"], x[:, 0])              # invariant readout


def eqv2_loss(params, batch, cfg) -> torch.Tensor:
    out = eqv2_forward(params, batch, cfg)
    if out.shape[-1] == 1:
        err = torch.square(out[:, 0] - batch["targets"])
        if batch.get("node_mask") is not None:
            err = err * batch["node_mask"]
            return err.sum() / torch.clamp(batch["node_mask"].sum(), min=1.0)
        return err.mean()
    return cm.cross_entropy(out, batch["labels"], batch.get("label_mask"))
