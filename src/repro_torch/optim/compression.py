"""int8 error-feedback gradient compression for the data-parallel
all-reduce (port of the JAX package's ``optim/compression.py``).

Per-tensor scale, int8 quantize, all-reduce in int32, dequantize; the
quantization residual is carried to the next step (error feedback keeps
SGD/Adam convergence, Karimireddy et al., arXiv:1901.09847).
``compressed_psum`` runs on ``torch.distributed``: one ``all_reduce(MAX)``
shares the scale, one int32 ``all_reduce(SUM)`` carries the payload (int8
payload semantics; the int32 carrier cannot overflow below 2^23 ranks).
"""

from __future__ import annotations

import torch
import torch.distributed as dist


def quantize(g: torch.Tensor):
    """(q int8, scale): ``g / scale`` rounded half to even into
    [-127, 127], ``scale = max(max|g|, 1e-12) / 127`` in float32."""
    g = g.float()
    scale = torch.clamp(g.abs().max(), min=1e-12) / 127.0
    q = torch.clamp(torch.round(g / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale


def ef_compress(g: torch.Tensor, error: torch.Tensor):
    """Error-feedback quantize: returns (q, scale, new_error)."""
    corrected = g.float() + error
    q, scale = quantize(corrected)
    new_error = corrected - dequantize(q, scale)
    return q, scale, new_error


def compressed_psum(g: torch.Tensor, error: torch.Tensor, group=None):
    """The int8-payload mean of ``g`` over the ranks of ``group`` (None:
    the default group), with error feedback.  Returns (mean float32
    gradient, this rank's new error)."""
    corrected = g.float() + error
    gmax = corrected.abs().max().reshape(1)
    dist.all_reduce(gmax, op=dist.ReduceOp.MAX, group=group)
    scale = torch.clamp(gmax[0], min=1e-12) / 127.0
    q = torch.clamp(torch.round(corrected / scale), -127, 127).to(torch.int8)
    new_error = corrected - q.float() * scale
    total = q.to(torch.int32)
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    n = dist.get_world_size(group)
    return total.float() * scale / n, new_error
