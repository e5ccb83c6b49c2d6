"""LM architecture registry: ``--arch <id>`` -> config.

The names are the JAX package's LM archs, in its order."""
from __future__ import annotations

import importlib

ARCHS = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "phi3.5-moe-42b-a6.6b": "repro_torch.configs.phi3_5_moe",
    "moonshot-v1-16b-a3b": "repro_torch.configs.moonshot_v1_16b",
}
LM_ARCHS = list(ARCHS)


def get_config(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; LM archs: {LM_ARCHS}")
    return importlib.import_module(ARCHS[arch]).CONFIG
