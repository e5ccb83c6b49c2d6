"""LM-family cells (port of the JAX package's ``configs/lm_family.py``):
train_4k / prefill_32k / decode_32k / long_500k.

``long_500k`` is a decode shape: a step's attention costs O(cache), not
O(cache^2); prefill is never built at 500k.  Decode cells donate the cache
(``donate=(1,)``): the port has no donation, and ``decode_step`` writes
the cache in place and returns the same ``k`` and ``v``, which is what
donation buys.  Each step runs where its inputs lie (``device=`` their
device), so a cell runs on the card or on a fake mesh alike.
"""

from __future__ import annotations

from functools import partial

import torch

from repro_torch.configs import cells as C
from repro_torch.models import common as cm
from repro_torch.models import transformer as T
from repro_torch.models.common import P
from repro_torch.optim import adamw

SHAPES = {
    "train_4k": dict(kind="train", seq=4096, batch=256),
    "prefill_32k": dict(kind="prefill", seq=32768, batch=32),
    "decode_32k": dict(kind="decode", seq=32768, batch=128),
    "long_500k": dict(kind="decode", seq=524288, batch=1, long=True),
}

OCFG = adamw.AdamWConfig(lr=3e-4, warmup_steps=2000, total_steps=100_000)


def _attn_fwd_flops(cfg: T.LMConfig, batch: int, seq: int) -> float:
    """Causal attention matmul flops (QK^T + PV), window-aware per layer."""
    per_layer_full = 2 * 2 * batch * seq * seq * cfg.n_q * cfg.d_head / 2
    per_layer_local = (2 * 2 * batch * seq * min(cfg.window, seq) * cfg.n_q
                       * cfg.d_head)
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % len(cfg.pattern)]
        total += per_layer_local if kind == "local" else per_layer_full
    return total


def _decode_attn_flops(cfg: T.LMConfig, batch: int, cache: int) -> float:
    total = 0.0
    for i in range(cfg.n_layers):
        kind = cfg.pattern[i % len(cfg.pattern)]
        s = min(cfg.window, cache) if kind == "local" else cache
        total += 2 * 2 * batch * s * cfg.n_q * cfg.d_head
    return total


def model_flops(cfg: T.LMConfig, shape_id: str) -> float:
    sh = SHAPES[shape_id]
    n_active = cfg.active_param_count()
    if sh["kind"] == "train":
        toks = sh["batch"] * sh["seq"]
        return 3 * (2 * n_active * toks
                    + _attn_fwd_flops(cfg, sh["batch"], sh["seq"]))
    if sh["kind"] == "prefill":
        toks = sh["batch"] * sh["seq"]
        return (2 * n_active * toks
                + _attn_fwd_flops(cfg, sh["batch"], sh["seq"]))
    return (2 * n_active * sh["batch"]
            + _decode_attn_flops(cfg, sh["batch"], sh["seq"]))


def make_cells(arch: str, cfg: T.LMConfig, microbatches: int = 8) -> dict:
    cells = {}
    for shape_id, sh in SHAPES.items():
        cells[shape_id] = C.Cell(
            arch=arch, shape=shape_id, kind=sh["kind"],
            model_flops=model_flops(cfg, shape_id),
            build=partial(_build, cfg, sh, microbatches),
            donate=(1,) if sh["kind"] == "decode" else (),
        )
    return cells


def _build(cfg: T.LMConfig, sh: dict, microbatches: int, mesh):
    """The cell of shape ``sh`` (an entry of ``SHAPES``) on ``mesh``."""
    b, s = sh["batch"], sh["seq"]
    params_abs = C.abstract_params(
        lambda: T.init_params(torch.Generator(), cfg))
    pspecs = T.param_specs(cfg)
    psh, osh = C.train_state_shardings(mesh, pspecs, params_abs)

    if sh["kind"] == "train":
        opt_abs = C.abstract_params(adamw.init_state, params_abs)
        batch_abs = {"tokens": C.sds((b, s), torch.int32),
                     "labels": C.sds((b, s), torch.int32)}
        bsh = C.shardings(mesh, {"tokens": C.dp(mesh, None),
                                 "labels": C.dp(mesh, None)})
        # ZeRO-2: the gradient accumulator sharded like the master params
        gspecs = adamw.zero_specs(pspecs, params_abs,
                                  data_axes=cm.dp_axes(mesh),
                                  data_size=C.data_axis_size(mesh))["master"]
        step = C.make_train_step(
            lambda p, mb: T.loss_fn(p, mb, cfg,
                                    device=mb["tokens"].device)[0],
            OCFG, microbatches, grad_specs=gspecs)
        return step, (params_abs, opt_abs, batch_abs), (psh, osh, bsh)

    if sh["kind"] == "prefill":
        toks_abs = C.sds((b, s), torch.int32)
        tsh = C.shardings(mesh, C.dp(mesh, None))

        def step(params, tokens):
            return T.prefill(params, tokens, cfg, device=tokens.device)

        return step, (params_abs, toks_abs), (psh, tsh)

    # decode: the cache donated (updated in place), same out sharding
    long = sh.get("long", False)
    cache_abs = C.abstract_params(
        lambda: T.init_cache(cfg, b, s, device="cpu"))
    csh = C.shardings(mesh, T.cache_specs(cfg, long_context=long))
    toks_abs = C.sds((b,), torch.int32)
    tsh = C.shardings(mesh, P() if long else C.dp(mesh))

    def step(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg,
                             device=tokens.device)

    return (step, (params_abs, cache_abs, toks_abs), (psh, csh, tsh),
            (csh, None))
