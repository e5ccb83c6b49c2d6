"""Models of the port: the decoder-only LM family (``transformer``) with its
building blocks (``common``) and long-sequence attention (``attention``);
the four GNN archs (``gnn``) and DIN (``recsys``)."""
