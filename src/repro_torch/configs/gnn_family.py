"""The GNN family's shapes (full_graph_sm / minibatch_lg / ogb_products /
molecule), optimizer settings, flat batch sizes and flop counts, as plain
data (the JAX package's ``configs/gnn_family.py`` less the cell builders,
which wait for the cell layer).

Input d_feat and n_classes follow each shape's source dataset (Cora,
Reddit, ogbn-products, synthetic molecules); the arch configs keep their
depths and widths and adapt the input layer.  ``MOLECULE_EDGE_CHUNKS`` is
the edge chunking of the reference's EquiformerV2 molecule cell.
"""

from __future__ import annotations

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
