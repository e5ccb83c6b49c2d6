"""Reduced configs for smoke tests and the CPU-scale training command: the
same model code as the full configs, with depths, widths, vocabularies and
graph sizes cut as the JAX package's ``configs/reduced.py`` cuts them;
``make_reduced`` covers every arch of the registry (LM, GNN, DIN)."""

from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.data import graphgen
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.data.tokens import TokenStream
from repro_torch.device import resolve_device
from repro_torch.models import transformer as T
from repro_torch.models.gnn import models as G
from repro_torch.models.recsys import din as DIN
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


def reduced_gnn(cfg):
    if isinstance(cfg, G.MeshGraphNetConfig):
        return dataclasses.replace(cfg, n_layers=3, d_hidden=32, d_node_in=8)
    if isinstance(cfg, G.GraphSAGEConfig):
        return dataclasses.replace(cfg, d_hidden=32, d_in=8, n_classes=5)
    if isinstance(cfg, G.GATConfig):
        return dataclasses.replace(cfg, d_in=8, n_classes=5)
    if isinstance(cfg, G.EquiformerV2Config):
        return dataclasses.replace(cfg, n_layers=2, d_hidden=16, l_max=2,
                                   n_heads=4, d_in=8)
    raise TypeError(cfg)


def reduced_din(cfg: DIN.DINConfig) -> DIN.DINConfig:
    return dataclasses.replace(cfg, n_items=5000, n_cats=20)


def _gnn_batch(arch: str, seed: int = 0, *, device=None) -> dict:
    """The reduced GNN batch on ``device`` (None: the CUDA card): an
    Erdos-Renyi graph of 48 nodes and 160 edges through ``gnn_full_batch``
    (8 features, 5 classes), with the arch's targets."""
    dev = resolve_device(device)
    n = 48
    edges = graphgen.erdos_renyi(n, 160, seed=seed)
    b = graphgen.gnn_full_batch(n, edges, d_feat=8, n_classes=5, seed=seed)
    out = {k: b[k] for k in ("node_feat", "edge_index", "edge_mask",
                             "positions", "edge_feat")}
    rng = np.random.default_rng(seed)
    if arch == "meshgraphnet":
        out["targets"] = b["targets_vec"]
        out["node_mask"] = np.ones(n, np.float32)
    elif arch == "equiformer-v2":
        out["targets"] = rng.standard_normal(n).astype(np.float32)
        out["node_mask"] = np.ones(n, np.float32)
    else:
        out["labels"] = b["labels"]
        out["label_mask"] = b["label_mask"]
    return {k: torch.as_tensor(v, device=dev) for k, v in out.items()}


GNN_MODELS = {
    "meshgraphnet": (G.mgn_init, G.mgn_loss),
    "equiformer-v2": (G.eqv2_init, G.eqv2_loss),
    "graphsage-reddit": (G.sage_init, G.sage_loss),
    "gat-cora": (G.gat_init, G.gat_loss),
}


def make_reduced(arch: str, *, device=None):
    """``(cfg, init_fn, loss_fn, batch_fn)`` of any arch of the registry at
    smoke scale, on ``device`` (None: the CUDA card): the reduced config,
    parameters from a generator seeded with 0, the scalar training loss,
    and the batches as tensors (LM: ``TokenStream``, seq 32, batch 4; GNN:
    ``_gnn_batch`` with seed ``step % 7``; DIN: ``RecsysStream``, batch 8,
    seed 0)."""
    dev = resolve_device(device)
    full = registry.get_config(arch)
    gen = lambda: torch.Generator(device=dev).manual_seed(0)

    def tensors(arrays):
        return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}

    if arch in registry.LM_ARCHS:
        cfg = reduced_lm(full)
        stream = TokenStream(cfg.vocab, seq_len=32, global_batch=4, seed=0)
        return (cfg,
                lambda: T.init_params(gen(), cfg),
                lambda p, b: T.loss_fn(p, b, cfg, device=dev)[0],
                lambda step: tensors(stream.batch(step)))
    if arch in registry.GNN_ARCHS:
        cfg = reduced_gnn(full)
        init, loss = GNN_MODELS[arch]
        return (cfg,
                lambda: init(gen(), cfg),
                lambda p, b: loss(p, b, cfg),
                lambda step: _gnn_batch(arch, seed=step % 7, device=dev))
    cfg = reduced_din(full)
    stream = RecsysStream(cfg.n_items, cfg.n_cats, cfg.seq_len,
                          global_batch=8, seed=0)
    return (cfg,
            lambda: DIN.din_init(gen(), cfg),
            lambda p, b: DIN.din_loss(p, b, cfg),
            lambda step: tensors(stream.batch(step)))
