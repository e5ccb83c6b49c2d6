"""Tiny configurations of the two families the cells serve, for the CPU
tests of the benchmark (the cells themselves run only on the card)."""

import pytest


def tiny_config(family: str, dtype: str = "float32", capacity: float = 1.25,
                layers: int = 2) -> dict:
    """A configuration file's shape at toy widths: ``dsmoe`` (MHA,
    shared experts), ``phi`` (GQA group 4, no shared expert) or ``dense``
    (a dense FFN, q / k / v biases, a tied embedding)."""
    ds = family == "dsmoe"
    if family == "dense":
        conf = tiny_config("phi", dtype, capacity, layers)
        conf["port"] |= {"n_experts": 0, "d_ff": 48, "qkv_bias": True,
                         "tie_embed": True}
        return conf
    port = {"n_layers": layers, "d_model": 64, "n_q": 4, "n_kv": 4 if ds else 1,
            "d_head": 16, "vocab": 256, "qkv_bias": False, "tie_embed": False,
            "pattern": ["full"], "rope_theta": 10000.0,
            "n_experts": 8, "top_k": 2, "d_ff_expert": 32,
            "n_shared_experts": 1 if ds else 0, "capacity_factor": capacity,
            "norm_eps": 1e-6 if ds else 1e-5, "dtype": dtype}
    return {"name": f"tiny-{family}", "port": port}


PREFILL = {"loop": "closed", "batch": 4, "prompt_len": 24,
           "new_tokens": 0, "max_seq": 24, "ids": "uniform"}
DECODE = {"loop": "closed", "batch": 4, "prompt_len": 16,
          "new_tokens": 6, "max_seq": 22, "ids": "uniform"}
MIXED = dict(DECODE, prompt_len=[8, 16, 12])
SKEWED = dict(PREFILL, ids="zipf", vocab_share=0.05, zipf_s=1.0)


@pytest.fixture
def cpu():
    import torch
    return torch.device("cpu")
