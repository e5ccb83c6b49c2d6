"""Shared model building blocks on tensors: initialisation from an explicit
``torch.Generator``, RMS and layer norm, SwiGLU, rotary embeddings, the
token-mean cross-entropy, the binary cross-entropy on logits and the
all-finite check of a training step.

The reference's mesh helpers (``shard``, ``dp_spec``) are the identity
without a mesh and are left out; the LM's mesh paths are ROADMAP A14.
"""

from __future__ import annotations

import math
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.tree import leaves


def dense_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    """Truncated-normal (at +-2 std) fan-in init (fan-in: ``shape[-2]``),
    drawn in float32 on the generator's device and cast to ``dtype``."""
    fan_in = shape[-2] if len(shape) > 1 else shape[0]
    x = torch.empty(shape, dtype=torch.float32, device=gen.device)
    torch.nn.init.trunc_normal_(x, 0.0, 1.0, -2.0, 2.0, generator=gen)
    return (x / math.sqrt(fan_in)).to(dtype)


def embed_init(gen: torch.Generator, shape,
               dtype=torch.float32) -> torch.Tensor:
    x = torch.randn(shape, generator=gen, dtype=torch.float32,
                    device=gen.device)
    return (x * 0.02).to(dtype)


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    """RMS norm in float32, scaled by ``1 + weight``; x's dtype out."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    xf = xf * torch.rsqrt(var + eps)
    return (xf * (1.0 + weight.float())).to(x.dtype)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    """Layer norm over the last dim in float32 (biased variance); x's dtype
    out."""
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = (xf - mu).square().mean(dim=-1, keepdim=True)
    xf = (xf - mu) * torch.rsqrt(var + eps)
    return (xf * weight.float() + bias.float()).to(x.dtype)


def swiglu(gate: torch.Tensor, up: torch.Tensor) -> torch.Tensor:
    """silu in float32, cast to the gate's dtype, times ``up``."""
    return F.silu(gate.float()).to(gate.dtype) * up


def rope_freqs(d_head: int, theta: float) -> np.ndarray:
    return 1.0 / (theta ** (np.arange(0, d_head, 2, dtype=np.float64)
                            / d_head))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, D), rotated on the last dim by halves (not
    interleaved); positions: (..., S)."""
    d = x.shape[-1]
    freqs = torch.as_tensor(rope_freqs(d, theta), dtype=torch.float32,
                            device=x.device)                    # (D/2,)
    ang = positions[..., None].float() * freqs                 # (..., S, D/2)
    cos = torch.cos(ang)[..., None, :]                     # (..., S, 1, D/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Token-mean cross-entropy in float32; logits (..., V), labels (...)
    int.  With ``mask``, the masked mean over ``max(mask.sum(), 1)``."""
    logits = logits.float()
    lse = torch.logsumexp(logits, dim=-1)
    ll = logits.gather(-1, labels.long()[..., None])[..., 0]
    nll = lse - ll
    if mask is not None:
        nll = nll * mask
        return nll.sum() / torch.clamp(mask.sum(), min=1.0)
    return nll.mean()


def bce_with_logits(logits: torch.Tensor,
                    labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy of ``logits`` against 0/1 ``labels``, in
    float32, in the overflow-free form ``max(z, 0) - z y + log1p(e^-|z|)``.
    At z = 0 the gradient takes the reference's one-sided derivatives (max:
    1/2 to each side; |z|: 1), so it equals JAX's there too."""
    z, y = logits.float(), labels.float()
    abs_z = torch.where(z >= 0, z, -z)
    return (torch.maximum(z, torch.zeros_like(z)) - z * y
            + torch.log1p(torch.exp(-abs_z))).mean()


def finite_check(tree) -> torch.Tensor:
    """A bool tensor: every floating tensor of a tree of dicts, lists and
    tuples (on one device) is finite; True when there is none."""
    oks = [torch.isfinite(x).all() for x in leaves(tree)
           if isinstance(x, torch.Tensor) and x.is_floating_point()]
    return torch.stack(oks).all() if oks else torch.tensor(True)
