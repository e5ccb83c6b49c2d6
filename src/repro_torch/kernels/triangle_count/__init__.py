"""Dense triangle counting S = (A . A) o A: the CUDA kernel (``kernel``), its
plain PyTorch version (``ref``) and the support wrappers (``ops``)."""
