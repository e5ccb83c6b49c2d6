"""Plain PyTorch version of the flash-attention kernel.

Causal (optionally sliding-window) GQA attention in float32: query head h
reads kv head h // group, key j is visible from query i when j <= i (causal)
and i - window < j (window), masked logits are -inf, and the output is cast
to q's dtype.
"""

from __future__ import annotations

import math

import torch


def mha_reference(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  causal: bool = True, window: int | None = None
                  ) -> torch.Tensor:
    """q: (B, Hq, S, D); k, v: (B, Hkv, S, D).  Returns (B, Hq, S, D)."""
    b, hq, s, d = q.shape
    hkv = k.shape[1]
    if hq % hkv:
        raise ValueError(f"q heads must be a multiple of kv heads for GQA, "
                         f"got hq={hq}, hkv={hkv}")
    group = hq // hkv
    kf = k.repeat_interleave(group, dim=1)
    vf = v.repeat_interleave(group, dim=1)
    scale = 1.0 / math.sqrt(d)
    logits = torch.einsum("bhqd,bhkd->bhqk", q.float(), kf.float()) * scale
    qi = torch.arange(s, device=q.device)[:, None]
    kj = torch.arange(k.shape[2], device=q.device)[None, :]
    mask = torch.ones((s, k.shape[2]), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kj <= qi
    if window is not None:
        mask &= kj > qi - window
    logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.exp(logits - logits.amax(dim=-1, keepdim=True))
    probs = probs / probs.sum(dim=-1, keepdim=True)
    out = torch.einsum("bhqk,bhkd->bhqd", probs, vf.float())
    return out.to(q.dtype)
