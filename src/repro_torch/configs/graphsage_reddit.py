"""graphsage-reddit [gnn] — 2 layers, d_hidden=128, mean aggregator,
sample sizes 25-10 (the minibatch shape trains with fanouts 15-10).
[arXiv:1706.02216]"""
from repro_torch.configs import gnn_family
from repro_torch.models.gnn.models import GraphSAGEConfig

CONFIG = GraphSAGEConfig(n_layers=2, d_hidden=128, aggregator="mean")
CELLS = gnn_family.sage_cells("graphsage-reddit", CONFIG)
