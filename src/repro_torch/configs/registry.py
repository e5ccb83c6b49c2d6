"""Architecture registry: ``--arch <id>`` -> config module, config and
cells.

The names are the JAX package's ten archs, in its order: five LMs, four
GNNs and DIN.  Importing a config module builds its ``CELLS`` dict but no
cell: a cell's ``build`` runs only when it is called."""
from __future__ import annotations

import importlib

ARCHS = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b",
    "meshgraphnet": "repro_torch.configs.meshgraphnet",
    "equiformer-v2": "repro_torch.configs.equiformer_v2",
    "graphsage-reddit": "repro_torch.configs.graphsage_reddit",
    "gat-cora": "repro_torch.configs.gat_cora",
    "din": "repro_torch.configs.din",
}

LM_ARCHS = [a for a in ARCHS if a in (
    "qwen2.5-14b", "gemma3-4b", "granite-8b",
    "phi3.5-moe-42b-a6.6b", "moonshot-v1-16b-a3b")]
GNN_ARCHS = ["meshgraphnet", "equiformer-v2", "graphsage-reddit", "gat-cora"]
RECSYS_ARCHS = ["din"]


def get_module(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; archs: {list(ARCHS)}")
    return importlib.import_module(ARCHS[arch])


def get_config(arch: str):
    return get_module(arch).CONFIG


def get_cells(arch: str) -> dict:
    return get_module(arch).CELLS


def get_cell(arch: str, shape: str):
    return get_cells(arch)[shape]


def all_cells():
    for arch in ARCHS:
        for cell in get_cells(arch).values():
            yield cell
