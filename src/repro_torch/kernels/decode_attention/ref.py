"""Plain PyTorch version of the decode-attention kernel (B5), and the path
of ``DTensor`` caches.

Grouped GQA attention of one new query token a row over the cache as two
matmuls on permuted float32 views, no KV repeat: key t is seen from row b
when t <= pos[b] and, with a window, t > pos[b] - window; masked scores are
-1e30; the softmax and P V are float32, and the output is cast to q's dtype.
The JAX package's ``_decode_attention`` computes the same with two einsums.
"""

from __future__ import annotations

import math

import torch


def decode_attention(q: torch.Tensor, ck: torch.Tensor, cv: torch.Tensor,
                     pos: torch.Tensor, window: int | None = None
                     ) -> torch.Tensor:
    """q: (B, 1, Hq, D); ck, cv: (B, S, Hkv, D); pos: (B,) each row's
    position.  Returns (B, 1, Hq, D) in q's dtype."""
    b, _, hq, dh = q.shape
    s, hkv = ck.shape[1], ck.shape[2]
    g = hq // hkv
    scale = 1.0 / math.sqrt(dh)
    qg = q.reshape(b, hkv, g, dh).float()
    # matmuls on permuted views of the cache (DTensor's einsum drops the
    # sharded size-1 dims)
    logits = torch.matmul(qg, ck.float().permute(0, 2, 3, 1)) * scale
    kvpos = torch.arange(s, dtype=torch.int32, device=q.device)
    valid = kvpos[None, :] <= pos[:, None]
    if window is not None:
        valid &= kvpos[None, :] > pos[:, None] - window
    logits = torch.where(valid[:, None, None], logits, -1e30)
    p = torch.softmax(logits, dim=-1)
    out = torch.matmul(p, cv.float().permute(0, 2, 1, 3))
    return out.reshape(b, 1, hq, dh).to(q.dtype)
