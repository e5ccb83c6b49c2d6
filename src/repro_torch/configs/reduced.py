"""Reduced LM configs for smoke tests and the CPU-scale serving and
training commands: the same model code as the full configs, with depth,
widths and vocabulary cut as the JAX package's ``configs/reduced.py::
reduced_lm`` cuts them; ``make_reduced`` is that file's LM branch."""

from __future__ import annotations

import dataclasses

import torch

from repro_torch.configs import registry
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
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
        microbatches=1, attn_chunk=64,
    )


def make_reduced(arch: str, *, device=None):
    """``(cfg, init_fn, loss_fn, batch_fn)`` of an LM arch at smoke scale,
    on ``device`` (None: the CUDA card): the reduced config, parameters
    from a generator seeded with 0, the scalar training loss, and the
    ``TokenStream`` batches (seq 32, batch 4, seed 0) as int32 tensors."""
    dev = resolve_device(device)
    cfg = reduced_lm(registry.get_config(arch))
    stream = TokenStream(cfg.vocab, seq_len=32, global_batch=4, seed=0)

    def batch_fn(step):
        return {k: torch.as_tensor(v, device=dev)
                for k, v in stream.batch(step).items()}

    return (cfg,
            lambda: T.init_params(torch.Generator(device=dev).manual_seed(0),
                                  cfg),
            lambda p, b: T.loss_fn(p, b, cfg, device=dev)[0],
            batch_fn)
