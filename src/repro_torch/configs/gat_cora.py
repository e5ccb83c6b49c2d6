"""gat-cora [gnn] — 2 layers, d_hidden=8, 8 heads, attention aggregator.
[arXiv:1710.10903]"""
from repro_torch.configs import gnn_family
from repro_torch.models.gnn.models import GATConfig

CONFIG = GATConfig(n_layers=2, d_hidden=8, n_heads=8)
CELLS = gnn_family.gat_cells("gat-cora", CONFIG)
