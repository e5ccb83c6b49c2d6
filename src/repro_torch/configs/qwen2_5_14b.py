"""qwen2.5-14b [dense] — 48L d_model=5120 40H (GQA kv=8) d_ff=13824
vocab=152064; GQA with QKV bias.  [hf:Qwen/Qwen2.5-14B]"""
import torch

from repro_torch.configs import lm_family
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="qwen2.5-14b", n_layers=48, d_model=5120, n_q=40, n_kv=8,
    d_head=128, d_ff=13824, vocab=152064, qkv_bias=True, tie_embed=False,
    pattern=("full",), rope_theta=1_000_000.0,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, microbatches=8,
)
CELLS = lm_family.make_cells("qwen2.5-14b", CONFIG, microbatches=8)
