"""The GNN substrate (port of the JAX package's ``models/gnn``): message
passing on edge lists (``layers``), real Wigner rotations (``wigner``), the
four archs (``models``) and the host-side neighbour sampler (``sampler``).
"""
