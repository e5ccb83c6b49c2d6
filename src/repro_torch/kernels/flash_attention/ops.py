"""Public flash-attention op: the CUDA kernel on CUDA tensors, the plain
version on CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.flash_attention import kernel, ref


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, window: int | None = None
                    ) -> torch.Tensor:
    """Causal / sliding-window GQA attention; (B, H, S, D) in and out."""
    if q.device.type == "cpu":
        return ref.mha_reference(q, k, v, causal=causal, window=window)
    return kernel.flash_attention(q, k, v, causal=causal, window=window)
