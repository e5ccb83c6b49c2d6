"""Synthetic data: graph generators and GNN batches (``graphgen``), the LM
token stream (``tokens``) and the DIN click stream (``recsys_stream``)."""
