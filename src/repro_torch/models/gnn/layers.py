"""GNN message-passing primitives on edge lists (port of the JAX package's
``models/gnn/layers.py``).

Message passing is a gather over an edge index and a scatter back into the
nodes: ``jax.ops.segment_sum`` becomes ``index_add``, ``segment_max``
becomes ``scatter_reduce(..., "amax", include_self=False)`` over a tensor
of ``-inf``, so an empty segment gives ``-inf`` as the reference's does and
is then replaced by 0.  Every op is out of place, so autograd reaches every
input.  Padded edges carry a mask.  Under ``common.use_mesh`` with
``DTensor`` inputs (the dry run) a segment sum scatters each rank's own
edges into a pending sum over the mesh, and a segment max runs
replicated.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import common as cm


def _mask(mask: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    """``mask`` (E,) broadcast against ``like`` (E, ...)."""
    return mask.reshape(mask.shape + (1,) * (like.dim() - 1))


def segment_sum(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    return cm.edge_sum(lambda x, seg: x.new_zeros(
        (n,) + tuple(x.shape[1:])).index_add(0, seg.long(), x), x, seg)


def segment_max(x: torch.Tensor, seg: torch.Tensor, n: int) -> torch.Tensor:
    """The max of each segment; ``-inf`` where a segment is empty.  Under a
    mesh it runs replicated (``DTensor`` has no sharding rule for
    ``scatter_reduce``)."""
    def local(x, seg):
        idx = _mask(seg.long(), x).expand(x.shape)
        return x.new_full((n,) + tuple(x.shape[1:]),
                          float("-inf")).scatter_reduce(
            0, idx, x, "amax", include_self=False)

    return cm.replicated(local, x, seg)


def segment_softmax(scores: torch.Tensor, seg_ids: torch.Tensor,
                    n_segments: int, mask=None) -> torch.Tensor:
    """Softmax over the entries grouped by ``seg_ids`` (GAT's edge softmax),
    in float32; ``scores`` is (E,) or (E, H), each column on its own."""
    scores = scores.float()
    if mask is not None:
        scores = torch.where(_mask(mask, scores), scores, -1e30)
    smax = segment_max(scores, seg_ids, n_segments)
    smax = torch.where(torch.isfinite(smax), smax, 0.0)
    seg = seg_ids.long()
    ex = torch.exp(scores - cm.gather(smax, seg))
    if mask is not None:
        ex = torch.where(_mask(mask, ex), ex, 0.0)
    denom = segment_sum(ex, seg, n_segments)
    return ex / torch.clamp(cm.gather(denom, seg), min=1e-9)


def aggregate(msgs: torch.Tensor, dst: torch.Tensor, n_nodes: int,
              agg: str = "sum", mask=None) -> torch.Tensor:
    """Scatter-aggregate the edge messages (E, F) into their destination
    nodes by ``sum``, ``mean`` (over the unmasked edges, at least 1) or
    ``max`` (0 where a node has none)."""
    if mask is not None:
        msgs = torch.where(mask[:, None], msgs, 0.0)
    if agg == "sum":
        return segment_sum(msgs, dst, n_nodes)
    if agg == "mean":
        s = segment_sum(msgs, dst, n_nodes)
        ones = msgs.new_ones(msgs.shape[0])
        if mask is not None:
            ones = torch.where(mask, ones, 0.0)
        cnt = segment_sum(ones, dst, n_nodes)
        return s / torch.clamp(cnt[:, None], min=1.0)
    if agg == "max":
        if mask is not None:
            msgs = torch.where(mask[:, None], msgs, -1e30)
        out = segment_max(msgs, dst, n_nodes)
        return torch.where(torch.isfinite(out), out, 0.0)
    raise ValueError(agg)


def mlp(params: list, x: torch.Tensor, act=F.relu,
        final_act: bool = False) -> torch.Tensor:
    for i, (w, b) in enumerate(params):
        x = x @ w + b
        if i < len(params) - 1 or final_act:
            x = act(x)
    return x


def mlp_init(gen: torch.Generator, dims, dtype=torch.float32) -> list:
    """``[(w, b), ...]``: fan-in truncated-normal weights, zero biases."""
    return [(cm.dense_init(gen, (dims[i], dims[i + 1]), dtype=dtype),
             torch.zeros((dims[i + 1],), dtype=dtype, device=gen.device))
            for i in range(len(dims) - 1)]


# ---------------------------------------------------------------------------
# Layers used by the archs
# ---------------------------------------------------------------------------

def sage_layer(params, h, src, dst, n_nodes, edge_mask=None, agg="mean"):
    """GraphSAGE: h' = ReLU(W_self h + W_nbr agg_j h_j + b)."""
    nbr = aggregate(cm.gather(h, src.long()), dst, n_nodes, agg=agg,
                    mask=edge_mask)
    return F.relu(h @ params["w_self"] + nbr @ params["w_nbr"] + params["b"])


def gat_layer(params, h, src, dst, n_nodes, n_heads, d_head, edge_mask=None,
              negative_slope=0.2, final=False):
    """GAT: multi-head edge attention (scores on the edges, an edge softmax
    over each destination per head, the weighted sum of the sources)."""
    H, Dh = n_heads, d_head
    src, dst = src.long(), dst.long()
    # node state replicated under a mesh (the edges carry the sharding)
    z = cm.shard(h @ params["w"], cm.P()).reshape(-1, H, Dh)  # (N, H, Dh)
    a_src = torch.einsum("nhd,hd->nh", z, params["a_src"])
    a_dst = torch.einsum("nhd,hd->nh", z, params["a_dst"])
    e = F.leaky_relu(cm.gather(a_src, src) + cm.gather(a_dst, dst),
                     negative_slope)                           # (E, H)
    alpha = segment_softmax(e, dst, n_nodes, mask=edge_mask)  # (E, H)
    msgs = cm.gather(z, src) * alpha[..., None]               # (E, H, Dh)
    out = aggregate(msgs.reshape(msgs.shape[0], -1), dst, n_nodes,
                    agg="sum", mask=edge_mask).reshape(-1, H, Dh)
    if final:
        return out.mean(dim=1)                                # average heads
    return F.elu(out.reshape(-1, H * Dh))
