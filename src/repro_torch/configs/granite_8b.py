"""granite-8b [dense] — 36L d_model=4096 32H (GQA kv=8) d_ff=14336
vocab=49152; llama-arch code model.  [arXiv:2405.04324]"""
import torch

from repro_torch.configs import lm_family
from repro_torch.models.transformer import LMConfig

CONFIG = LMConfig(
    name="granite-8b", n_layers=36, d_model=4096, n_q=32, n_kv=8,
    d_head=128, d_ff=14336, vocab=49152, qkv_bias=False, tie_embed=True,
    pattern=("full",), rope_theta=10_000_000.0,
    param_dtype=torch.bfloat16, compute_dtype=torch.bfloat16,
    remat=True, microbatches=8,
)
CELLS = lm_family.make_cells("granite-8b", CONFIG, microbatches=8)
