"""Fused frontier-peel round: the CUDA kernel (``kernel``), its plain
PyTorch version (``ref``) and the lockstep peel loops over it (``ops``)."""
