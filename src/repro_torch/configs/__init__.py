"""Configurations of the port: copies of the JAX package's arch configs
(dense LMs: ``gemma3_4b``, ``granite_8b``, ``qwen2_5_14b``; MoE:
``phi3_5_moe``, ``moonshot_v1_16b``; GNNs: ``meshgraphnet``,
``equiformer_v2``, ``graphsage_reddit``, ``gat_cora``; ``din``) with torch
dtypes, the families' shapes, flop counts and cell builders
(``lm_family``, ``gnn_family``, ``recsys_family``), each config module's
``CELLS``, the arch registry, the reduced smoke-test sizes (``reduced``),
and the cell abstraction and training step (``cells``)."""
