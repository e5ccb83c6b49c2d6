"""meshgraphnet [gnn] — 15 layers, d_hidden=128, sum aggregator,
2-layer MLPs.  [arXiv:2010.03409]"""
from repro_torch.configs import gnn_family
from repro_torch.models.gnn.models import MeshGraphNetConfig

CONFIG = MeshGraphNetConfig(n_layers=15, d_hidden=128, mlp_layers=2,
                            aggregator="sum")
CELLS = gnn_family.mgn_cells("meshgraphnet", CONFIG)
