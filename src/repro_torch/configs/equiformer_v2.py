"""equiformer-v2 [gnn] — 12 layers, d_hidden=128, l_max=6, m_max=2,
8 heads, SO(2)-eSCN equivariant convolutions.  [arXiv:2306.12059]
The shapes have no 3D geometry: the data pipeline draws synthetic
positions.  The cells wait for the cell layer."""
from repro_torch.models.gnn.models import EquiformerV2Config

CONFIG = EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                            n_heads=8)
