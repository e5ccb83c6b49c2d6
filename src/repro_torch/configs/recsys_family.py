"""DIN cells (port of the JAX package's ``configs/recsys_family.py``):
train_batch / serve_p99 / serve_bulk / retrieval_cand, with the family's
optimizer settings and flop counts.  ``RETRIEVAL_CHUNKS`` is the chunk
count the retrieval cell scores 1 M candidates in: 1 M is not divisible by
256, so candidates shard over the data axes only and each 20,000-row
chunk shards inside."""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch.configs import cells as C
from repro_torch.models.common import P
from repro_torch.models.recsys import din as DIN
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


def _serve_batch_abs(cfg: DINConfig, b: int) -> dict:
    return {
        "hist_items": C.sds((b, cfg.seq_len), torch.int32),
        "hist_cats": C.sds((b, cfg.seq_len), torch.int32),
        "hist_mask": C.sds((b, cfg.seq_len)),
        "cand_item": C.sds((b,), torch.int32),
        "cand_cat": C.sds((b,), torch.int32),
    }


def make_cells(arch: str, cfg: DINConfig) -> dict:
    cells = {}
    for shape_id, sh in SHAPES.items():
        cells[shape_id] = C.Cell(
            arch=arch, shape=shape_id, kind=sh["kind"],
            model_flops=model_flops(cfg, shape_id),
            build=partial(_build, cfg, sh),
        )
    return cells


def _batch_shardings(mesh, batch_abs):
    return C.shardings(mesh, {
        k: C.dp(mesh, *([None] * (len(v.shape) - 1)))
        for k, v in batch_abs.items()})


def _build(cfg: DINConfig, sh: dict, mesh):
    """The cell of shape ``sh`` (an entry of ``SHAPES``) on ``mesh``."""
    b = sh["batch"]
    params_abs = C.abstract_params(
        lambda: DIN.din_init(torch.Generator(), cfg))
    pspecs = DIN.param_specs(cfg)
    psh = C.shardings(mesh, pspecs)

    if sh["kind"] == "train":
        opt_abs = C.abstract_params(adamw.init_state, params_abs)
        _, osh = C.train_state_shardings(mesh, pspecs, params_abs)
        batch_abs = {**_serve_batch_abs(cfg, b), "label": C.sds((b,))}
        step = C.make_train_step(
            lambda p, mb: DIN.din_loss(p, mb, cfg), OCFG, microbatches=1)
        return (step, (params_abs, opt_abs, batch_abs),
                (psh, osh, _batch_shardings(mesh, batch_abs)))

    if sh["kind"] == "serve":
        batch_abs = _serve_batch_abs(cfg, b)

        def step(params, batch):
            return DIN.din_scores(params, batch, cfg)

        return (step, (params_abs, batch_abs),
                (psh, _batch_shardings(mesh, batch_abs)))

    # retrieval: 1 user x 1 M candidates over the data axes
    nc = sh["n_candidates"]
    cfg_r = dataclasses.replace(cfg, cand_chunks=RETRIEVAL_CHUNKS)
    batch_abs = {
        "hist_items": C.sds((1, cfg.seq_len), torch.int32),
        "hist_cats": C.sds((1, cfg.seq_len), torch.int32),
        "hist_mask": C.sds((1, cfg.seq_len)),
        "cand_items": C.sds((nc,), torch.int32),
        "cand_cats": C.sds((nc,), torch.int32),
    }
    bsh = C.shardings(mesh, {
        "hist_items": P(None, None), "hist_cats": P(None, None),
        "hist_mask": P(None, None),
        "cand_items": C.dp(mesh),
        "cand_cats": C.dp(mesh),
    })

    def step(params, batch):
        return DIN.din_retrieval(params, batch, cfg_r)

    return step, (params_abs, batch_abs), (psh, bsh)
