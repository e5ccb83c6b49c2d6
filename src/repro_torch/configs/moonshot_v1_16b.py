"""moonshot-v1-16b-a3b [moe] — 48L d_model=2048 16H (MHA kv=16) d_ff=1408
vocab=163840, 64 experts top-6 + 2 shared (DeepSeek/Moonlight style).
[hf:moonshotai/Moonlight-16B-A3B]  Deviation: Moonlight's first dense layer
is modeled as MoE like the rest (DESIGN.md §7)."""
import torch

from repro_torch.configs import lm_family
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="moonshot-v1-16b-a3b", n_layers=48, d_model=2048, n_q=16, n_kv=16,
    d_head=128, vocab=163840, qkv_bias=False, tie_embed=False,
    pattern=("full",), rope_theta=50_000.0,
    n_experts=64, top_k=6, d_ff_expert=1408, n_shared_experts=2,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, microbatches=8,
)
CELLS = lm_family.make_cells("moonshot-v1-16b-a3b", CONFIG, microbatches=8)
