"""Memory-bounded attention paths for long sequences, in plain PyTorch.

The plain route of the LM's attention when the flash kernel is off and the
sequence is longer than ``attn_chunk``:

* ``chunked_attention``: online softmax over (q_chunk x k_chunk) tiles, peak
  memory O(bq bk) per (batch, head) instead of O(S^2); causal masking by
  -1e30 inside each tile.
* ``banded_attention``: sliding-window layers; each q chunk attends to the
  band [chunk_start - window, chunk_end) of keys, O(S (W + bq)) work.

Both take GQA by a head-group reshape without repeating the keys, in the
layout (B, S, H, D), and compute in float32.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

_NEG = -1e30


def _gqa_split(q, k, v):
    """(B,S,Hq,D),(B,S,Hk,D) -> grouped (B,Hk,G,S,D), (B,Hk,S,D) forms."""
    b, sq, hq, d = q.shape
    hk = k.shape[2]
    g = hq // hk
    qg = q.reshape(b, sq, hk, g, d).permute(0, 2, 3, 1, 4)   # B,Hk,G,Sq,D
    return qg, k.transpose(1, 2), v.transpose(1, 2), g


def chunked_attention(q, k, v, *, causal=True, q_chunk=512, k_chunk=1024,
                      positions_q=None, positions_kv=None):
    """Online-softmax attention; layouts (B, S, H, D) in and out.  The
    causal mask compares ``positions_kv`` (Skv,) with ``positions_q``
    (Sq,), each ``arange`` when not given."""
    b, sq, hq, d = q.shape
    skv = k.shape[1]
    q_chunk = min(q_chunk, sq)
    k_chunk = min(k_chunk, skv)
    if sq % q_chunk or skv % k_chunk:
        raise ValueError(f"chunk sizes must divide the sequence lengths: "
                         f"sq={sq} %% q_chunk={q_chunk}, "
                         f"skv={skv} %% k_chunk={k_chunk}")
    scale = 1.0 / math.sqrt(d)
    qg, kg, vg, g = _gqa_split(q, k, v)
    hk = kg.shape[1]
    positions_q = (torch.arange(sq, device=q.device) if positions_q is None
                   else torch.as_tensor(positions_q, device=q.device))
    positions_kv = (torch.arange(skv, device=q.device) if positions_kv is None
                    else torch.as_tensor(positions_kv, device=q.device))
    blocks = []
    for i in range(0, sq, q_chunk):
        qb = qg[:, :, :, i:i + q_chunk].float()
        pq = positions_q[i:i + q_chunk]
        m = torch.full((b, hk, g, q_chunk), _NEG, dtype=torch.float32,
                       device=q.device)
        l = torch.zeros_like(m)
        acc = torch.zeros((b, hk, g, q_chunk, d), dtype=torch.float32,
                          device=q.device)
        for j in range(0, skv, k_chunk):
            kb = kg[:, :, j:j + k_chunk].float()
            vb = vg[:, :, j:j + k_chunk].float()
            pk = positions_kv[j:j + k_chunk]
            s = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
            if causal:
                mask = pk[None, :] <= pq[:, None]              # (bq, bk)
                s = torch.where(mask, s, _NEG)
            m2 = torch.maximum(m, s.amax(dim=-1))
            alpha = torch.exp(m - m2)
            p = torch.exp(s - m2[..., None])
            l = l * alpha + p.sum(dim=-1)
            acc = acc * alpha[..., None] + torch.einsum(
                "bhgqk,bhkd->bhgqd", p, vb)
            m = m2
        blocks.append(acc / torch.clamp(l, min=1e-30)[..., None])
    out = torch.cat(blocks, dim=3)                       # B,Hk,G,Sq,D
    return out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, d).to(q.dtype)


def banded_attention(q, k, v, *, window, q_chunk=512):
    """Sliding-window causal attention: q chunk i sees keys
    [i bq - W, i bq + bq)."""
    b, s, hq, d = q.shape
    q_chunk = min(q_chunk, s)
    if s % q_chunk:
        raise ValueError(f"q_chunk={q_chunk} must divide the sequence "
                         f"length s={s}")
    scale = 1.0 / math.sqrt(d)
    qg, kg, vg, g = _gqa_split(q, k, v)
    W = window
    band = W + q_chunk                       # static band width
    # pad keys at the front so every band slice is in range
    kp = F.pad(kg, (0, 0, W, 0))
    vp = F.pad(vg, (0, 0, W, 0))
    blocks = []
    for i in range(0, s, q_chunk):
        qb = qg[:, :, :, i:i + q_chunk].float()
        kb = kp[:, :, i:i + band].float()
        vb = vp[:, :, i:i + band].float()
        s_ = torch.einsum("bhgqd,bhkd->bhgqk", qb, kb) * scale
        pq = i + torch.arange(q_chunk, device=q.device)
        pk = i - W + torch.arange(band, device=q.device)
        mask = ((pk[None, :] <= pq[:, None]) & (pk[None, :] > pq[:, None] - W)
                & (pk[None, :] >= 0))
        s_ = torch.where(mask, s_, _NEG)
        p = torch.softmax(s_, dim=-1)
        blocks.append(torch.einsum("bhgqk,bhkd->bhgqd", p, vb))
    out = torch.cat(blocks, dim=3)
    return out.permute(0, 3, 1, 2, 4).reshape(b, s, hq, d).to(q.dtype)
