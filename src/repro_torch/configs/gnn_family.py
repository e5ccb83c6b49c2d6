"""GNN-family cells (port of the JAX package's ``configs/gnn_family.py``):
full_graph_sm / minibatch_lg / ogb_products / molecule, all training
cells, with the family's optimizer settings, flat batch sizes and flop
counts.

Input d_feat and n_classes follow each shape's source dataset (Cora,
Reddit, ogbn-products, synthetic molecules); the arch configs keep their
depths and widths and adapt the input layer.  ``MOLECULE_EDGE_CHUNKS`` is
the edge chunking of EquiformerV2's molecule cell.

Sharding: edge arrays shard over every mesh axis (pure edge parallelism),
node arrays replicate.  Exceptions:
* ``ogb_products`` for GraphSAGE and EquiformerV2: node-sharded state and
  the ring reduce-scatter (``models/gnn/distributed.py``), EquiformerV2's
  ring payload in bf16;
* EquiformerV2 x ``minibatch_lg``: 1,024 sampled subtrees over the data
  axes.  The reference vmaps the forward over the trees; the subtrees are
  disjoint, so the port runs one union graph (node ids offset by tree) and
  reads each root, which gives every root its own tree's value
  (``eqv2_tree_loss``).
"""

from __future__ import annotations

import dataclasses
from functools import partial

import torch

from repro_torch import tree
from repro_torch.configs import cells as C
from repro_torch.models import common as cm
from repro_torch.models.common import P
from repro_torch.models.gnn import models as G
from repro_torch.optim import adamw

OCFG = adamw.AdamWConfig(lr=1e-3, warmup_steps=100, total_steps=20_000)

SHAPES = {
    "full_graph_sm": dict(n=2708, e=10556, d_feat=1433, n_classes=7),
    "minibatch_lg": dict(n=232_965, e=114_615_892, d_feat=602, n_classes=41,
                         batch_nodes=1024, fanouts=(15, 10)),
    "ogb_products": dict(n=2_449_029, e=61_859_140, d_feat=100, n_classes=47),
    "molecule": dict(n_graphs=128, nodes=30, edges=64, d_feat=16),
}

MOLECULE_EDGE_CHUNKS = 8
_EDGE_PAD = 512   # lcm of both production mesh sizes


def _pad_to(x: int, m: int = _EDGE_PAD) -> int:
    return -(-x // m) * m


def _flat_sizes(shape_id):
    """(n_nodes, n_directed_edges): edges padded to shard over 256/512
    devices (the data pipeline pads with masked entries)."""
    sh = SHAPES[shape_id]
    if shape_id == "minibatch_lg":
        b, (f1, f2) = sh["batch_nodes"], sh["fanouts"]
        n = b * (1 + f1 + f1 * f2)
        e = b * (f1 + f1 * f2)
        return n, _pad_to(e)
    if shape_id == "molecule":
        return (sh["n_graphs"] * sh["nodes"],
                _pad_to(sh["n_graphs"] * sh["edges"] * 2))
    return sh["n"], _pad_to(sh["e"] * 2)


# flop estimates of one training step (forward and backward)

def mgn_flops(cfg, n, e):
    c = cfg.d_hidden
    per_layer = 2 * e * (4 * c * c) + 2 * n * (3 * c * c)
    return 3 * cfg.n_layers * per_layer


def sage_flops(cfg, n, e, d_in):
    total, d = 0.0, d_in
    for _ in range(cfg.n_layers):
        total += 2 * 2 * n * d * cfg.d_hidden + 2 * e * d
        d = cfg.d_hidden
    return 3 * total


def gat_flops(cfg, n, e, d_in, n_classes):
    total, d = 0.0, d_in
    for i in range(cfg.n_layers):
        dh = n_classes if i == cfg.n_layers - 1 else cfg.d_hidden
        total += 2 * n * d * cfg.n_heads * dh + 4 * e * cfg.n_heads * dh
        d = cfg.n_heads * dh
    return 3 * total


def eqv2_flops(cfg, n, e):
    S, Cc = cfg.n_sph, cfg.d_hidden
    rot = 2 * 2 * e * S * S * Cc
    so2 = 0.0
    for m in range(cfg.m_max + 1):
        n_l = cfg.l_max + 1 - m
        so2 += 2 * e * n_l * n_l * Cc * Cc * (2 if m else 1)
    return 3 * cfg.n_layers * (rot + so2)


# ---------------------------------------------------------------------------
# batches and the generic training cell
# ---------------------------------------------------------------------------

def _batch_abs(shape_id, *, need_edge_feat=False, need_pos=False,
               regression=False):
    sh = SHAPES[shape_id]
    n, e = _flat_sizes(shape_id)
    batch = {
        "node_feat": C.sds((n, sh["d_feat"])),
        "edge_index": C.sds((e, 2), torch.int32),
        "edge_mask": C.sds((e,), torch.bool),
    }
    if need_edge_feat:
        batch["edge_feat"] = C.sds((e, 4))
    if need_pos:
        batch["positions"] = C.sds((n, 3))
    if regression:
        batch["targets"] = C.sds((n, 3) if need_edge_feat else (n,))
        batch["node_mask"] = C.sds((n,))
    else:
        batch["labels"] = C.sds((n,), torch.int32)
        batch["label_mask"] = C.sds((n,))
    return batch


def _batch_specs(mesh, batch):
    ax = tuple(a for a in ("pod", "data", "model") if a in mesh.mesh_dim_names)
    specs = {}
    for k, v in batch.items():
        if k.startswith("edge"):
            specs[k] = P(ax, *([None] * (len(v.shape) - 1)))
        else:
            specs[k] = P(*([None] * len(v.shape)))   # nodes replicated
    return C.shardings(mesh, specs)


def _train_cell(arch, shape_id, cfg, loss_fn, init_fn, flops, batch_builder,
                notes=""):
    def build(mesh):
        params_abs = C.abstract_params(init_fn)
        opt_abs = C.abstract_params(adamw.init_state, params_abs)
        batch_abs, bsh = batch_builder(mesh)
        step = C.make_train_step(loss_fn, OCFG, microbatches=1)
        return step, (params_abs, opt_abs, batch_abs), (None, None, bsh)

    return C.Cell(arch=arch, shape=shape_id, kind="train",
                  model_flops=flops, build=build, notes=notes)


def _ring_axes(mesh) -> tuple:
    return tuple(a for a in ("data", "model") if a in mesh.mesh_dim_names)


def _ring_sizes(mesh, sh) -> tuple:
    """(P, padded node count, Eb) of a ring cell: P ranks over ("data",
    "model"), the nodes padded to a multiple of P, and buckets of twice
    the mean bucket load (at least 64).  The ring's group is made here,
    when the cell is built (every rank makes it in the same order)."""
    from repro_torch.models.gnn import distributed as D

    _, Pn, _ = D.ring_group(mesh)
    n_pad = -(-sh["n"] // Pn) * Pn
    Eb = max(64, int(2 * sh["e"] * 2 / (Pn * Pn)))
    return Pn, n_pad, Eb


def _ring_shardings(mesh, batch_abs):
    ax = _ring_axes(mesh)
    return C.shardings(mesh, {k: P(ax, *([None] * (len(v.shape) - 1)))
                              for k, v in batch_abs.items()})


def _gen():
    return torch.Generator()


# ---------------------------------------------------------------------------
# per-arch cell builders
# ---------------------------------------------------------------------------

def mgn_cells(arch, base: G.MeshGraphNetConfig):
    cells = {}
    for shape_id in SHAPES:
        sh = SHAPES[shape_id]
        n, e = _flat_sizes(shape_id)
        cfg = dataclasses.replace(base, d_node_in=sh["d_feat"])

        def builder(mesh, shape_id=shape_id):
            b = _batch_abs(shape_id, need_edge_feat=True, regression=True)
            return b, _batch_specs(mesh, b)

        cells[shape_id] = _train_cell(
            arch, shape_id, cfg,
            lambda p, b, cfg=cfg: G.mgn_loss(p, b, cfg),
            lambda cfg=cfg: G.mgn_init(_gen(), cfg),
            mgn_flops(cfg, n, e), builder)
    return cells


def sage_cells(arch, base: G.GraphSAGEConfig):
    from repro_torch.models.gnn import distributed as D

    cells = {}
    for shape_id in SHAPES:
        sh = SHAPES[shape_id]
        n, e = _flat_sizes(shape_id)
        cfg = dataclasses.replace(base, d_in=sh["d_feat"],
                                  n_classes=sh.get("n_classes", 2))

        if shape_id == "ogb_products":
            def build(mesh, cfg=cfg, sh=sh):
                Pn, n_pad, Eb = _ring_sizes(mesh, sh)
                batch_abs = {
                    "node_feat": C.sds((n_pad, sh["d_feat"])),
                    "labels": C.sds((n_pad,), torch.int32),
                    "label_mask": C.sds((n_pad,)),
                    "src_loc": C.sds((Pn, Pn, Eb), torch.int32),
                    "dst_loc": C.sds((Pn, Pn, Eb), torch.int32),
                    "edge_mask": C.sds((Pn, Pn, Eb), torch.bool),
                }
                params_abs = C.abstract_params(
                    lambda: G.sage_init(_gen(), cfg))
                opt_abs = C.abstract_params(adamw.init_state, params_abs)
                step = C.make_train_step(
                    lambda p, b: D.sage_ring_loss(p, b, cfg, mesh), OCFG)
                return (step, (params_abs, opt_abs, batch_abs),
                        (None, None, _ring_shardings(mesh, batch_abs)))

            cells[shape_id] = C.Cell(
                arch=arch, shape=shape_id, kind="train",
                model_flops=sage_flops(cfg, sh["n"], sh["e"] * 2, cfg.d_in),
                build=build, notes="ring reduce-scatter node-sharded path")
            continue

        def builder(mesh, shape_id=shape_id):
            b = _batch_abs(shape_id)
            return b, _batch_specs(mesh, b)

        cells[shape_id] = _train_cell(
            arch, shape_id, cfg,
            lambda p, b, cfg=cfg: G.sage_loss(p, b, cfg),
            lambda cfg=cfg: G.sage_init(_gen(), cfg),
            sage_flops(cfg, n, e, cfg.d_in), builder)
    return cells


def gat_cells(arch, base: G.GATConfig):
    cells = {}
    for shape_id in SHAPES:
        sh = SHAPES[shape_id]
        n, e = _flat_sizes(shape_id)
        cfg = dataclasses.replace(base, d_in=sh["d_feat"],
                                  n_classes=sh.get("n_classes", 2))

        def builder(mesh, shape_id=shape_id):
            b = _batch_abs(shape_id)
            return b, _batch_specs(mesh, b)

        cells[shape_id] = _train_cell(
            arch, shape_id, cfg,
            lambda p, b, cfg=cfg: G.gat_loss(p, b, cfg),
            lambda cfg=cfg: G.gat_init(_gen(), cfg),
            gat_flops(cfg, n, e, cfg.d_in, cfg.n_classes), builder)
    return cells


def eqv2_tree_roots(params, node_feat, positions, edge_index, edge_mask,
                    cfg: G.EquiformerV2Config):
    """Each subtree's root output (B,): node_feat (B, nt, F), positions
    (B, nt, 3), edge_index (B, et, 2) with tree-local ids, edge_mask (B,
    et); the roots (node 0 of each tree) are read from one union graph of
    the B trees."""
    B, nt = node_feat.shape[:2]
    offs = (torch.arange(B, device=edge_index.device) * nt).to(
        edge_index.dtype)
    union = {
        "node_feat": node_feat.reshape(B * nt, -1),
        "positions": positions.reshape(B * nt, 3),
        "edge_index": (edge_index + offs[:, None, None]).reshape(-1, 2),
        "edge_mask": edge_mask.reshape(-1),
    }
    return G.eqv2_forward(params, union, cfg)[:, 0].reshape(B, nt)[:, 0]


def eqv2_tree_loss(params, batch, cfg: G.EquiformerV2Config):
    """EquiformerV2 x ``minibatch_lg``'s loss: the mean squared error of
    the B subtrees' roots against ``batch["targets"]`` (B,).  On a
    ``DTensor`` batch each rank runs its own trees (``local_map`` over the
    data axes, as the reference vmaps over them)."""
    keys = ("node_feat", "positions", "edge_index", "edge_mask")
    if not cm.is_dtensor(batch["node_feat"]):
        out = eqv2_tree_roots(params, *(batch[k] for k in keys), cfg=cfg)
    else:
        from torch.distributed.tensor.experimental import local_map

        mesh = batch["node_feat"].device_mesh

        leaves = tree.leaves(params)
        rep = cm.placements(mesh, P())
        trees = cm.placements(mesh, cm.dp_spec())
        roots = local_map(
            lambda *a: eqv2_tree_roots(
                tree.unflatten_like(params, a[4:]), *a[:4], cfg=cfg),
            out_placements=trees,
            in_placements=(trees,) * 4 + (rep,) * len(leaves),
            in_grad_placements=(trees,) * 4
            + (cm.local_grad(trees),) * len(leaves),
            device_mesh=mesh, redistribute_inputs=True)
        out = roots(*(batch[k] for k in keys), *leaves)
    return torch.mean(torch.square(out - batch["targets"]))


def eqv2_cells(arch, base: G.EquiformerV2Config):
    from repro_torch.models.gnn import distributed as D

    cells = {}
    for shape_id in SHAPES:
        sh = SHAPES[shape_id]
        n, e = _flat_sizes(shape_id)
        cfg = dataclasses.replace(base, d_in=sh["d_feat"])

        if shape_id == "ogb_products":
            # bf16 ring payload: halves the dominant link term
            cfg = dataclasses.replace(cfg, ring_dtype="bf16")

            def build(mesh, cfg=cfg, sh=sh):
                Pn, n_pad, Eb = _ring_sizes(mesh, sh)
                batch_abs = {
                    "node_feat": C.sds((n_pad, sh["d_feat"])),
                    "positions": C.sds((n_pad, 3)),
                    "targets": C.sds((n_pad,)),
                    "node_mask": C.sds((n_pad,)),
                    "src_loc": C.sds((Pn, Pn, Eb), torch.int32),
                    "dst_loc": C.sds((Pn, Pn, Eb), torch.int32),
                    "edge_mask": C.sds((Pn, Pn, Eb), torch.bool),
                    "dst_pos": C.sds((Pn, Pn, Eb, 3)),
                }
                params_abs = C.abstract_params(
                    lambda: G.eqv2_init(_gen(), cfg))
                opt_abs = C.abstract_params(adamw.init_state, params_abs)
                step = C.make_train_step(
                    lambda p, b: D.eqv2_ring_loss(p, b, cfg, mesh), OCFG)
                return (step, (params_abs, opt_abs, batch_abs),
                        (None, None, _ring_shardings(mesh, batch_abs)))

            cells[shape_id] = C.Cell(
                arch=arch, shape=shape_id, kind="train",
                model_flops=eqv2_flops(cfg, sh["n"], sh["e"] * 2),
                build=build, notes="ring reduce-scatter node-sharded path")
            continue

        if shape_id == "minibatch_lg":
            b_seeds = sh["batch_nodes"]
            nt = 1 + sh["fanouts"][0] + sh["fanouts"][0] * sh["fanouts"][1]
            et = nt - 1

            def build(mesh, cfg=cfg, b_seeds=b_seeds, nt=nt, et=et):
                batch_abs = {
                    "node_feat": C.sds((b_seeds, nt, cfg.d_in)),
                    "positions": C.sds((b_seeds, nt, 3)),
                    "edge_index": C.sds((b_seeds, et, 2), torch.int32),
                    "edge_mask": C.sds((b_seeds, et), torch.bool),
                    "targets": C.sds((b_seeds,)),
                }
                bsh = C.shardings(mesh, {
                    k: C.dp(mesh, *([None] * (len(v.shape) - 1)))
                    for k, v in batch_abs.items()})
                params_abs = C.abstract_params(
                    lambda: G.eqv2_init(_gen(), cfg))
                opt_abs = C.abstract_params(adamw.init_state, params_abs)
                step = C.make_train_step(
                    partial(eqv2_tree_loss, cfg=cfg), OCFG)
                return step, (params_abs, opt_abs, batch_abs), (None, None,
                                                                bsh)

            cells[shape_id] = C.Cell(
                arch=arch, shape=shape_id, kind="train",
                model_flops=eqv2_flops(cfg, b_seeds * nt, b_seeds * et),
                build=build, notes="per-seed batched subtrees (vmap)")
            continue

        chunks = MOLECULE_EDGE_CHUNKS if shape_id == "molecule" else 1
        cfg_c = dataclasses.replace(cfg, edge_chunks=chunks)

        def builder(mesh, shape_id=shape_id):
            b = _batch_abs(shape_id, need_pos=True, regression=True)
            b["targets"] = C.sds((_flat_sizes(shape_id)[0],))
            return b, _batch_specs(mesh, b)

        cells[shape_id] = _train_cell(
            arch, shape_id, cfg_c,
            lambda p, b, cfg_c=cfg_c: G.eqv2_loss(p, b, cfg_c),
            lambda cfg_c=cfg_c: G.eqv2_init(_gen(), cfg_c),
            eqv2_flops(cfg_c, n, e), builder)
    return cells
