"""DIN's shapes (train_batch / serve_p99 / serve_bulk / retrieval_cand),
its optimizer settings and its flop counts, as plain data (the JAX
package's ``configs/recsys_family.py`` less the cell builders, which wait
for the cell layer).  ``RETRIEVAL_CHUNKS`` is the chunk count the
reference's retrieval cell scores 1 M candidates in."""

from __future__ import annotations

from repro_torch.models.recsys.din import DINConfig
from repro_torch.optim import adamw

OCFG = adamw.AdamWConfig(lr=1e-3, warmup_steps=500, total_steps=50_000)

SHAPES = {
    "train_batch": dict(kind="train", batch=65_536),
    "serve_p99": dict(kind="serve", batch=512),
    "serve_bulk": dict(kind="serve", batch=262_144),
    "retrieval_cand": dict(kind="retrieval", batch=1, n_candidates=1_000_000),
}

RETRIEVAL_CHUNKS = 50


def din_fwd_flops(cfg: DINConfig, batch: int) -> float:
    d = cfg.embed_dim
    a0, a1 = cfg.attn_mlp
    attn = cfg.seq_len * (4 * d * a0 + a0 * a1 + a1)
    head = 3 * d * cfg.mlp[0] + cfg.mlp[0] * cfg.mlp[1] + cfg.mlp[1]
    return 2.0 * batch * (attn + head)


def model_flops(cfg: DINConfig, shape_id: str) -> float:
    sh = SHAPES[shape_id]
    b = sh.get("n_candidates", sh["batch"])
    f = din_fwd_flops(cfg, b)
    return 3 * f if sh["kind"] == "train" else f
