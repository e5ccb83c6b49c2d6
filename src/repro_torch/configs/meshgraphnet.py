"""meshgraphnet [gnn] — 15 layers, d_hidden=128, sum aggregator,
2-layer MLPs.  [arXiv:2010.03409]  The cells wait for the cell layer."""
from repro_torch.models.gnn.models import MeshGraphNetConfig

CONFIG = MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2,
                            aggregator="sum")
