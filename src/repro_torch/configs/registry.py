"""LM architecture registry: ``--arch <id>`` -> config.

The names are the JAX package's LM archs.  The MoE ones raise
``NotImplementedError``: their expert layers wait for a later slice of the
port (ROADMAP A14).
"""
from __future__ import annotations

import importlib

ARCHS = {
    "qwen2.5-14b": "repro_torch.configs.qwen2_5_14b",
    "gemma3-4b": "repro_torch.configs.gemma3_4b",
    "granite-8b": "repro_torch.configs.granite_8b",
    "phi3.5-moe-42b-a6.6b": None,
    "moonshot-v1-16b-a3b": None,
}
LM_ARCHS = list(ARCHS)


def get_config(arch: str):
    if arch not in ARCHS:
        raise ValueError(f"unknown arch {arch!r}; LM archs: {LM_ARCHS}")
    module = ARCHS[arch]
    if module is None:
        raise NotImplementedError(
            f"{arch} is a MoE config; MoE layers wait for a later slice of "
            f"the port (ROADMAP A14)")
    return importlib.import_module(module).CONFIG
