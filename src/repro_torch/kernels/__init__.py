"""Hand-written Hopper kernels of the port, each beside its plain PyTorch
version: ``frontier_peel`` (the fused peel round), ``triangle_count``
(dense-core supports), ``flash_attention`` (the LM prefill's attention) and
``embedding_bag`` (bag lookups).  ``build`` compiles ``csrc/`` on first
use."""


def check_kernel(kernel: str) -> None:
    """Validate a ``kernel=`` knob: ``"auto"`` is the only value — the CUDA
    kernel for CUDA tensors, the plain version for CPU tensors."""
    if kernel != "auto":
        raise ValueError(
            f"unknown kernel {kernel!r}: only 'auto' (the CUDA kernel for "
            f"CUDA tensors, the plain version for CPU tensors) is supported")
