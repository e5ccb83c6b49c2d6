"""Reduced LM configs for smoke tests and the CPU-scale serving command: the
same model code as the full configs, with depth, widths and vocabulary cut
as the JAX package's ``configs/reduced.py::reduced_lm`` cuts them."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.models.transformer import LMConfig


def reduced_lm(cfg: LMConfig) -> LMConfig:
    pat = cfg.pattern
    n_layers = max(2 * len(pat) + (1 if cfg.n_layers % len(pat) else 0),
                   2 + cfg.n_layers % len(pat))
    return dataclasses.replace(
        cfg, n_layers=n_layers, d_model=64,
        n_q=4, n_kv=max(1, 4 * cfg.n_kv // cfg.n_q), d_head=16,
        d_ff=128, d_ff_expert=32 if cfg.moe else 0,
        n_experts=min(cfg.n_experts, 8), vocab=211,
        param_dtype=torch.float32, compute_dtype=torch.float32,
        attn_chunk=64,
    )
