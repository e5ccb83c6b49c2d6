"""LM configurations of the port: copies of the JAX package's LM configs
(dense: ``gemma3_4b``, ``granite_8b``, ``qwen2_5_14b``; MoE: ``phi3_5_moe``,
``moonshot_v1_16b``) with torch dtypes, the arch registry, the reduced
smoke-test sizes (``reduced``) and the training step (``cells``)."""
