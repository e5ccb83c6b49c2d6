"""Public decode-attention op: the CUDA kernel (B5) on CUDA tensors, the
plain version on CPU tensors."""

from __future__ import annotations

import torch

from repro_torch.kernels.decode_attention import kernel, ref


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, window: int | None = None
                     ) -> torch.Tensor:
    """One new query token a row over that row's cache; (B, 1, Hq, D) in
    q's dtype (shapes: ``ref.decode_attention``)."""
    if q.device.type == "cpu":
        return ref.decode_attention(q, ck, cv, pos, window)
    return kernel.decode_attention(q, ck, cv, pos, window)
