"""Embedding bag: the CUDA kernel (``kernel``), its plain PyTorch version
(``ref``) and the op (``ops``)."""
