"""LM configurations of the port: copies of the JAX package's dense LM
configs (``gemma3_4b``, ``granite_8b``, ``qwen2_5_14b``) with torch dtypes
and without their training knobs, the arch registry and the reduced
smoke-test sizes."""
