"""gat-cora [gnn] — 2 layers, d_hidden=8, 8 heads, attention aggregator.
[arXiv:1710.10903]  The cells wait for the cell layer."""
from repro_torch.models.gnn.models import GATConfig

CONFIG = GATConfig(n_layers=2, d_hidden=8, n_heads=8)
