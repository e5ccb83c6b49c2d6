"""Plain reference of the MoE decoder the cells serve, in float32 with TF32
off, written from the configuration file's equations and not from the
program: it imports nothing of the program.

The layer, as the configuration files state it: RMS norm (scaled by
``1 + w``), q / k / v projections, RoPE over each head's halves (not
interleaved), causal attention with query head h reading kv head
``h // (n_q / n_kv)``, the output projection, a residual add; then RMS norm,
a float32 router softmax, the top-k experts with their weights renormalised
to sum to 1, capacity dispatch, SwiGLU experts, the shared experts on every
token, a residual add.  After the last layer an RMS norm and the head.

Capacity dispatch: the tokens of one call of the served path form a group
(a prefill: every prompt token of the batch; a decode step: the batch's one
new token each).  Each group gives an expert ``C = max(1, int(capacity_factor
* T * K / E))`` slots for its T tokens; slots are ranked in token-major, then
k, order (token t's k-th choice is slot t*K + k, tokens of a prefill in
(request, position) order, of a decode step in request order), and a slot
ranked C or later is dropped.  Running every layer over the whole sequence
at once with these groups gives what a prefill and then decode steps give,
since every group's tokens lie at one step of the sequence.

``quant="fp8"`` is the control: every weight matmul (projections, router
excepted, experts, shared experts, head) takes its operands rounded to
float8 e4m3 (activations scaled a row, weights a column, by amax / 448);
everything else stays float32.
"""

from __future__ import annotations

import math

import torch

FP8_MAX = 448.0
HEAD_ROWS = 1024          # rows of hidden states a head matmul takes at once


def strict_float32() -> None:
    """Float32 matmuls in float32: no TF32 on the card."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    """x rounded to float8 e4m3, scaled along ``dim`` by amax / 448."""
    scale = x.abs().amax(dim=dim, keepdim=True).clamp_min(1e-30) / FP8_MAX
    return (x / scale).to(torch.float8_e4m3fn).float() * scale


def _mm(x: torch.Tensor, w: torch.Tensor, quant: str | None) -> torch.Tensor:
    """x @ w in float32; under the fp8 control both operands are rounded
    first (x along its rows, w along its input dim)."""
    if quant == "fp8":
        return _fp8(x, -1) @ _fp8(w, -2)
    return x @ w


def _rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.square().mean(-1, keepdim=True) + eps) * (1.0 + w)


def _swiglu(x, wg, wu, wd, quant):
    g = _mm(x, wg, quant)
    return _mm(torch.nn.functional.silu(g) * _mm(x, wu, quant), wd, quant)


def _rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (B, N, H, D) at positions 0..N-1, rotated by halves."""
    n, d = x.shape[1], x.shape[3]
    freqs = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float64) / d))
    pos = torch.arange(n, dtype=torch.float32, device=x.device)
    ang = pos[:, None] * freqs.to(torch.float32).to(x.device)   # (N, D/2)
    cos, sin = torch.cos(ang)[:, None], torch.sin(ang)[:, None]
    x1, x2 = x.chunk(2, dim=-1)
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def _attention(q, k, v):
    """Causal GQA attention, one request at a time.  q: (B, N, Hq, D);
    k, v: (B, N, Hkv, D)."""
    b, n, hq, d = q.shape
    hkv = k.shape[2]
    g = hq // hkv
    mask = torch.ones((n, n), dtype=torch.bool, device=q.device).tril()
    out = torch.empty_like(q)
    for i in range(b):
        qi = q[i].reshape(n, hkv, g, d)
        s = torch.einsum("nhgd,mhd->hgnm", qi, k[i]) / math.sqrt(d)
        p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
        out[i] = torch.einsum("hgnm,mhd->nhgd", p, v[i]).reshape(n, hq, d)
    return out


def route(x: torch.Tensor, router: torch.Tensor, c: dict,
          group_sizes: list) -> tuple:
    """Routing of the rows of x (T, d), whose consecutive runs of
    ``group_sizes`` tokens are the groups.  Returns (token, expert, weight)
    of every kept slot."""
    e, k = c["n_experts"], c["top_k"]
    probs = torch.softmax(x @ router, dim=-1)
    topw, tope = torch.topk(probs, k, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    fe = tope.reshape(-1)
    oh = torch.nn.functional.one_hot(fe, e)
    before = oh.cumsum(0) - oh                 # slots of each expert before
    sizes = torch.as_tensor(group_sizes, device=x.device)
    first = (torch.cumsum(sizes, 0) - sizes) * k            # group's 1st slot
    slot_group = torch.repeat_interleave(torch.arange(len(group_sizes),
                                                      device=x.device),
                                         sizes * k)
    rank = (before.gather(1, fe[:, None])[:, 0]
            - before[first[slot_group], fe])
    cap = torch.as_tensor([max(1, int(c["capacity_factor"] * t * k / e))
                           for t in group_sizes], device=x.device)
    keep = rank < cap[slot_group]
    slots = keep.nonzero()[:, 0]
    return slots // k, fe[slots], topw.reshape(-1)[slots]


def _moe(h, lp, c, prefill_len, quant):
    """The MoE FFN of one layer over h (B, N, d), routed by groups."""
    b, n, d = h.shape
    s = prefill_len
    rows = [h[:, :s].reshape(b * s, d), h[:, s:].transpose(0, 1).reshape(-1, d)]
    x = torch.cat(rows)
    sizes = [b * s] + [b] * (n - s)
    tok, exp, w = route(x, lp["router"], c, sizes)
    out = torch.zeros_like(x)
    for e in range(c["n_experts"]):
        sel = (exp == e).nonzero()[:, 0]
        if sel.numel():
            t = tok[sel]
            y = _swiglu(x[t], lp["we_gate"][e], lp["we_up"][e],
                        lp["we_down"][e], quant)
            out.index_add_(0, t, y * w[sel, None])
    if c["n_shared_experts"]:
        out += _swiglu(x, lp["ws_gate"], lp["ws_up"], lp["ws_down"], quant)
    pre = out[:b * s].view(b, s, d)
    dec = out[b * s:].view(n - s, b, d).transpose(0, 1)
    return torch.cat([pre, dec], dim=1)


def _dense(h, lp, quant):
    return _swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], quant)


def final_hidden(params: dict, c: dict, tokens: torch.Tensor,
                 prefill_len: int, positions, quant: str | None = None
                 ) -> torch.Tensor:
    """Normed final hidden states (B, P, d) at ``positions`` of the
    sequences ``tokens`` (B, N): the first ``prefill_len`` positions as one
    prefill, each later position as one decode step.  Weights are read a
    layer at a time and widened to float32 there."""
    if set(c["pattern"]) != {"full"}:
        raise ValueError(f"the reference computes full causal attention "
                         f"only, not the pattern {c['pattern']}")
    strict_float32()
    b, n = tokens.shape
    dh, eps = c["d_head"], c["norm_eps"]
    x = params["embed"][tokens.long()].float()
    layers = params["layers"]
    for i in range(c["n_layers"]):
        lp = {name: a[i].float() for name, a in layers.items()}
        h = _rms(x, lp["ln1"], eps)
        q, k, v = (_mm(h, lp[w], quant) for w in ("wq", "wk", "wv"))
        if c.get("qkv_bias"):
            q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
        q = _rope(q.view(b, n, c["n_q"], dh), c["rope_theta"])
        k = _rope(k.view(b, n, c["n_kv"], dh), c["rope_theta"])
        o = _attention(q, k, v.view(b, n, c["n_kv"], dh))
        x = x + _mm(o.reshape(b, n, -1), lp["wo"], quant)
        h = _rms(x, lp["ln2"], eps)
        x = x + (_moe(h, lp, c, prefill_len, quant) if c["n_experts"]
                 else _dense(h, lp, quant))
        del lp, h, q, k, v, o
    return _rms(x[:, positions], params["final_norm"].float(), eps)


def _head(params: dict) -> torch.Tensor:
    return params["lm_head"] if "lm_head" in params else params["embed"].T


def _logit_blocks(params, hidden, quant):
    """(row slice, float32 logits) over blocks of HEAD_ROWS rows of the
    flattened hidden states."""
    head = _head(params).float()
    flat = hidden.reshape(-1, hidden.shape[-1])
    for r in range(0, flat.shape[0], HEAD_ROWS):
        yield slice(r, r + HEAD_ROWS), _mm(flat[r:r + HEAD_ROWS], head, quant)


def gaps(params: dict, hidden: torch.Tensor, served: torch.Tensor
         ) -> torch.Tensor:
    """By how much the logit of each served token (B, P) lies below the
    best logit at its position, under the float32 head: 0 where it is the
    reference's argmax."""
    strict_float32()
    flat = served.reshape(-1).long()
    out = torch.empty(flat.shape, dtype=torch.float32, device=hidden.device)
    for rows, logits in _logit_blocks(params, hidden, None):
        out[rows] = logits.amax(-1) - logits.gather(1, flat[rows, None])[:, 0]
    return out.view(served.shape)


def head_logits(params: dict, hidden: torch.Tensor,
                quant: str | None = None) -> torch.Tensor:
    """Logits (R, V) of normed hidden states (R, d), in float32 or in the
    control's precision."""
    strict_float32()
    return _mm(hidden, _head(params).float(), quant)


def relative_error(params: dict, hidden: torch.Tensor,
                   logits: torch.Tensor) -> torch.Tensor:
    """Per row of ``logits`` (R, V): its distance from the float32 head's
    logits of ``hidden`` (R, d), over their norm."""
    want = head_logits(params, hidden)
    got = logits.to(want.device, torch.float32)
    return (got - want).norm(dim=-1) / want.norm(dim=-1)


def argmax_tokens(params: dict, hidden: torch.Tensor,
                  quant: str | None = None) -> torch.Tensor:
    """The token each position (B, P) puts first under the head (in the
    control's precision when ``quant`` is given)."""
    strict_float32()
    out = []
    for _, logits in _logit_blocks(params, hidden, quant):
        out.append(logits.argmax(-1))
    return torch.cat(out).view(hidden.shape[:2])
