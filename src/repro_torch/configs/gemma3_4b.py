"""gemma3-4b [dense] — 34L d_model=2560 8H (GQA kv=4) d_ff=10240
vocab=262144; 5:1 local:global (window 1024), 128k context, tied embeddings.
[hf:google/gemma-3-4b-pt]"""
import torch

from repro_torch.configs import lm_family
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="gemma3-4b", n_layers=34, d_model=2560, n_q=8, n_kv=4,
    d_head=256, d_ff=10240, vocab=262144, qkv_bias=False, tie_embed=True,
    pattern=("local",) * 5 + ("global",), window=1024,
    rope_theta=1_000_000.0, rope_theta_local=10_000.0,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, microbatches=8,
)
CELLS = lm_family.make_cells("gemma3-4b", CONFIG, microbatches=8)
