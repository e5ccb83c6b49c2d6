"""din [recsys] — embed_dim=18, seq_len=100, attn MLP 80-40, MLP 200-80,
target attention.  [arXiv:1706.06978]  Vocabulary 10M items / 1k categories
(DIN-paper scale)."""
from repro_torch.configs import recsys_family
from repro_torch.models.recsys.din import DINConfig

CONFIG = DINConfig(n_items=10_000_000, n_cats=1_000, embed_dim=18,
                   seq_len=100, attn_mlp=(80, 40), mlp=(200, 80))
CELLS = recsys_family.make_cells("din", CONFIG)
