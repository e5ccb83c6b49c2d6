"""Flash attention: the CUDA kernel (``kernel``), its plain PyTorch version
(``ref``) and the op the model calls (``ops``)."""
