"""PyTorch/CUDA port of the truss-decomposition system (``repro``).

The package mirrors ``repro``'s layout (``core/``, ``data/``, ``kernels/``)
and imports neither JAX nor anything of ``repro``: host-side preprocessing
stays numpy, device work is torch on an explicit ``device``, and the two
Pallas kernels of the main path are hand-written CUDA under ``csrc/``.
"""
