"""phi3.5-moe-42b-a6.6b [moe] — 32L d_model=4096 32H (GQA kv=8) d_ff=6400
vocab=32064, 16 experts top-2.  [hf:microsoft/Phi-3.5-MoE-instruct]"""
import torch

from repro_torch.configs import lm_family
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="phi3.5-moe-42b-a6.6b", n_layers=32, d_model=4096, n_q=32, n_kv=8,
    d_head=128, vocab=32064, qkv_bias=False, tie_embed=False,
    pattern=("full",), rope_theta=10_000.0,
    n_experts=16, top_k=2, d_ff_expert=6400, n_shared_experts=0,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, microbatches=8,
)
CELLS = lm_family.make_cells("phi3.5-moe-42b-a6.6b", CONFIG, microbatches=8)
