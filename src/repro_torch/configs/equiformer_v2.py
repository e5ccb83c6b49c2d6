"""equiformer-v2 [gnn] — 12 layers, d_hidden=128, l_max=6, m_max=2,
8 heads, SO(2)-eSCN equivariant convolutions.  [arXiv:2306.12059]
The shapes have no 3D geometry: the data pipeline draws synthetic
positions."""
from repro_torch.configs import gnn_family
from repro_torch.models.gnn.models import EquiformerV2Config

CONFIG = EquiformerV2Config(n_layers=12, d_hidden=128, l_max=6, m_max=2,
                            n_heads=8)
CELLS = gnn_family.eqv2_cells("equiformer-v2", CONFIG)
