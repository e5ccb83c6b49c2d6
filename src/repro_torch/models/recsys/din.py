"""Deep Interest Network [arXiv:1706.06978] (port of the JAX package's
``models/recsys/din.py``).

Dims: embed_dim 18, seq_len 100, attention MLP 80-40, head MLP 200-80,
target attention; 10 M items and 1 k categories (the DIN paper's scale).
Shapes served: train_batch (B = 65,536, BCE training), serve_p99 (B =
512), serve_bulk (B = 262,144) and retrieval_cand (1 user x 1 M
candidates, scored chunk by chunk).

Embedding lookups (``_lookup``) take one of two routes, ``kernel=``:

* ``"bag"`` — the embedding-bag kernel (B4, ``kernels.embedding_bag``) in
  ``sum`` mode over bags of one row: the ids reshaped to (N, 1), one
  launch on ``item_emb`` and one on ``cat_emb``, the two results added as
  the reference adds its takes.  A bag of one row sums to ``0 + row``, so
  the route equals the take exactly (``-0.0`` reads back as ``0.0``);
* ``"take"`` — the plain index, the reference's ``jnp.take``.

The default is ``"bag"`` on CUDA tables and ``"take"`` on CPU tables, a
rule on the device, never a retry after a failure.  B4 has no backward (nor
has the reference's kernel), so under a gradient (``torch.
is_grad_enabled()`` and a table that requires grad) the default is
``"take"`` and an explicit ``"bag"`` raises ``ValueError``; ``din_loss``
takes ``"take"``.  ``param_specs`` puts the item table's rows over
"model".  Under ``common.use_mesh`` with ``DTensor`` tables (the dry run)
the take on a row-sharded table is ``DTensor``'s masked gather and sum,
the reference's ``sharded_lookup``; ``_lookup`` never calls
``embedding.sharded_lookup``, which is called on its own.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from repro_torch.kernels.embedding_bag import ops as bag_ops
from repro_torch.models import common as cm
from repro_torch.models.common import P, dp_spec, shard
from repro_torch.models.gnn.layers import mlp, mlp_init

KERNELS = ("bag", "take")


@dataclasses.dataclass(frozen=True)
class DINConfig:
    name: str = "din"
    n_items: int = 10_000_000
    n_cats: int = 1_000
    embed_dim: int = 18
    seq_len: int = 100
    attn_mlp: tuple = (80, 40)
    mlp: tuple = (200, 80)
    cand_chunks: int = 1024       # chunks of the retrieval scoring
    sharded_tables: bool = True   # the reference's field (see _lookup)

    def param_count(self) -> int:
        d = self.embed_dim
        attn = (4 * d + 1) * self.attn_mlp[0] + \
               (self.attn_mlp[0] + 1) * self.attn_mlp[1] + self.attn_mlp[1] + 1
        head_in = 3 * d
        head = (head_in + 1) * self.mlp[0] + (self.mlp[0] + 1) * self.mlp[1] \
            + self.mlp[1] + 1
        return (self.n_items + self.n_cats) * d + attn + head


def din_init(gen: torch.Generator, cfg: DINConfig) -> dict:
    """Parameters on the generator's device: the item and category tables
    (N(0, 0.02^2)) and the two MLPs."""
    d = cfg.embed_dim
    return {
        "item_emb": cm.embed_init(gen, (cfg.n_items, d)),
        "cat_emb": cm.embed_init(gen, (cfg.n_cats, d)),
        "attn": mlp_init(gen, [4 * d, *cfg.attn_mlp, 1]),
        "head": mlp_init(gen, [3 * d, *cfg.mlp, 1]),
    }


def param_specs(cfg: DINConfig) -> dict:
    """The item table's rows over "model"; the rest replicated."""
    return {
        "item_emb": P("model", None),
        "cat_emb": P(None, None),       # tiny: replicate
        "attn": [(P(None, None), P(None))] * 3,
        "head": [(P(None, None), P(None))] * 3,
    }


def lookup_route(params, kernel: Optional[str] = None) -> str:
    """The route ``_lookup`` takes: ``kernel`` checked, or the default rule
    on the tables' device and the gradient."""
    tables = (params["item_emb"], params["cat_emb"])
    grad = torch.is_grad_enabled() and any(t.requires_grad for t in tables)
    if kernel is None:
        return "bag" if tables[0].device.type == "cuda" and not grad \
            else "take"
    if kernel not in KERNELS:
        raise ValueError(f"kernel must be one of {KERNELS}, got {kernel!r}")
    if kernel == "bag" and grad:
        raise ValueError("kernel='bag' under a gradient: the embedding-bag "
                         "kernel has no backward (nor has the reference's "
                         "Pallas kernel); use kernel='take'")
    return kernel


def _bag(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """``table[ids]`` as B4 bags of one row in ``sum`` mode."""
    rows = bag_ops.embedding_bag(table, ids.reshape(-1, 1), mode="sum")
    return rows.reshape(tuple(ids.shape) + (table.shape[1],))


def _lookup(params, cfg, item_ids, cat_ids, kernel: Optional[str] = None):
    """``item_emb[item_ids] + cat_emb[cat_ids]`` by ``kernel``'s route."""
    if lookup_route(params, kernel) == "bag":
        return _bag(params["item_emb"], item_ids) + _bag(params["cat_emb"],
                                                         cat_ids)
    return cm.take(params["item_emb"], item_ids) + cm.take(
        params["cat_emb"], cat_ids)


def _target_attention(params, e_hist, hist_mask, e_cand):
    """DIN's adaptive interest: an MLP score a(e_h, e_c) for every history
    item, and the un-normalized weighted sum of the history."""
    e_c = e_cand[..., None, :].expand(e_hist.shape)
    feats = torch.cat([e_hist, e_c, e_hist - e_c, e_hist * e_c], dim=-1)
    w = mlp(params["attn"], feats)[..., 0]                 # (..., L)
    w = torch.sigmoid(w) * hist_mask
    return torch.einsum("...l,...ld->...d", w, e_hist)


def _mask(batch, ids):
    mask = batch.get("hist_mask")
    if mask is None:
        mask = torch.ones(ids.shape, dtype=torch.float32, device=ids.device)
    return mask


def din_scores(params, batch, cfg: DINConfig,
               kernel: Optional[str] = None) -> torch.Tensor:
    """Click logits (B,): ``batch`` holds hist_items / hist_cats (B, L),
    cand_item / cand_cat (B,) and optionally hist_mask (B, L)."""
    e_hist = _lookup(params, cfg, batch["hist_items"], batch["hist_cats"],
                     kernel)
    e_cand = _lookup(params, cfg, batch["cand_item"], batch["cand_cat"],
                     kernel)
    e_hist = shard(e_hist, dp_spec(None, None))
    user = _target_attention(params, e_hist,
                             _mask(batch, batch["hist_items"]), e_cand)
    z = torch.cat([user, e_cand, user * e_cand], dim=-1)
    return mlp(params["head"], z)[..., 0]


def din_loss(params, batch, cfg: DINConfig) -> torch.Tensor:
    """Mean BCE of ``din_scores`` (the take route) against batch["label"]."""
    return cm.bce_with_logits(din_scores(params, batch, cfg, kernel="take"),
                              batch["label"])


def din_retrieval(params, batch, cfg: DINConfig,
                  kernel: Optional[str] = None) -> torch.Tensor:
    """Scores of every candidate for one user: ``batch`` holds the user's
    hist_items / hist_cats (1, L) and cand_items / cand_cats (n,), scored in
    ``cfg.cand_chunks`` chunks, one after another (one lookup a chunk)."""
    e_hist = _lookup(params, cfg, batch["hist_items"], batch["hist_cats"],
                     kernel)                                  # (1, L, D)
    mask = _mask(batch, batch["hist_items"])
    cand_items, cand_cats = batch["cand_items"], batch["cand_cats"]
    n = cand_items.shape[0]
    k = cfg.cand_chunks
    if n % k:
        raise ValueError(f"candidate count n={n} must be divisible by "
                         f"cfg.cand_chunks={k}")
    # under a mesh the candidates shard inside each chunk, not over chunks
    chunk_spec = P(None, *dp_spec())
    scores = []
    chunks = [shard(shard(c, P(None)).reshape(k, n // k), chunk_spec)
              for c in (cand_items, cand_cats)]
    for ci, cc in zip(*chunks):
        e_c = _lookup(params, cfg, ci, cc, kernel)            # (nc, D)
        nc = e_c.shape[0]
        user = _target_attention(
            params, e_hist.expand((nc,) + tuple(e_hist.shape[1:])),
            mask.expand((nc,) + tuple(mask.shape[1:])), e_c)
        z = torch.cat([user, e_c, user * e_c], dim=-1)
        scores.append(mlp(params["head"], z)[..., 0])
    return torch.cat(scores)
