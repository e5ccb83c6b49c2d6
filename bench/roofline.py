"""Peaks of the card and the work of a serving step, counted from the
configuration's sizes: the yardstick the per-layer metrics divide by.

Peaks are NVIDIA's data sheet for one H100 SXM (dense, at its 700 W
limit): 989 TFLOP/s in bf16 on the tensor cores and 3.35 TB/s of HBM.
Operations count each multiply-add as two; bytes count each input byte
read once and each output byte written once.  ``b3_bound`` is copied from
``chip_smoke.py``'s bound of the flash-attention kernel.

A configuration here is the plain ``port`` group of a configuration file
(``bench/configs/*.json``): ``n_layers``, ``d_model``, ``n_q``, ``n_kv``,
``d_head``, ``vocab``, ``n_experts``, ``top_k``, ``d_ff_expert``,
``n_shared_experts``, ``qkv_bias``.
"""

from __future__ import annotations

import math

BF16_FLOPS_PER_S = 989e12
HBM_BYTES_PER_S = 3.35e12
BF16_BYTES = 2
F32_BYTES = 4


def attn_weights(c: dict) -> int:
    """Parameters of one layer's q, k, v and o projections (and biases)."""
    d, dh = c["d_model"], c["d_head"]
    n = d * (c["n_q"] + 2 * c["n_kv"]) * dh + c["n_q"] * dh * d
    if c.get("qkv_bias"):
        n += (c["n_q"] + 2 * c["n_kv"]) * dh
    return n


def expert_weights(c: dict) -> int:
    """Parameters of one routed expert (gate, up and down)."""
    return 3 * c["d_model"] * c["d_ff_expert"]


def active_layer_weights(c: dict) -> int:
    """Parameters a token passes through in one layer: attention, the
    router, its top-k experts and the shared experts."""
    return (attn_weights(c) + c["d_model"] * c["n_experts"]
            + (c["top_k"] + c["n_shared_experts"]) * expert_weights(c))


def visible_pairs(s: int) -> int:
    """(query, key) pairs of causal attention over s positions."""
    return s * (s + 1) // 2


def prefill_flops(c: dict, batch: int, s: int) -> float:
    """Model flops of one prefill of ``batch`` prompts of ``s`` tokens:
    2 x active parameters a token x tokens, causal attention's 4 Hq D a
    visible pair in every layer, and the head at the last position (the
    only one the prefill computes).  Capacity padding is not counted."""
    dense = 2 * active_layer_weights(c) * c["n_layers"] * batch * s
    attn = 4 * batch * c["n_q"] * c["d_head"] * c["n_layers"] * visible_pairs(s)
    head = 2 * c["d_model"] * c["vocab"] * batch
    return float(dense + attn + head)


def decode_step_flops(c: dict, batch: int, pos: int) -> float:
    """Model flops of one decode step at cache position ``pos`` (the new
    token sees ``pos + 1`` keys)."""
    dense = 2 * active_layer_weights(c) * c["n_layers"] * batch
    attn = 4 * batch * c["n_q"] * c["d_head"] * c["n_layers"] * (pos + 1)
    head = 2 * c["d_model"] * c["vocab"] * batch
    return float(dense + attn + head)


def experts_touched(c: dict, batch: int) -> float:
    """Expected routed experts a layer reads in a decode step of ``batch``
    tokens when each token picks top_k of n_experts uniformly: an expert
    gets no token with probability (1 - K / E) ** batch (e^-6 at 64 tokens,
    top 6 of 64).  Random weights route about uniformly."""
    e, k = c["n_experts"], c["top_k"]
    return e * (1.0 - (1.0 - k / e) ** batch)


def decode_step_bytes(c: dict, batch: int, pos: int) -> float:
    """Bytes one decode step needs, each read or written once: every layer
    weight it touches (attention, the float32 router, the experts that get
    a token, the shared experts, the norms), the embedding rows of its
    tokens, the head, the cache's keys and values at positions 0..pos, the
    new key and value written, and the logits."""
    d, L = c["d_model"], c["n_layers"]
    layer = (attn_weights(c) + c["n_shared_experts"] * expert_weights(c)
             + 2 * d) * BF16_BYTES
    layer += d * c["n_experts"] * F32_BYTES
    layer += experts_touched(c, batch) * expert_weights(c) * BF16_BYTES
    kv_row = 2 * c["n_kv"] * c["d_head"] * BF16_BYTES     # k and v, one token
    cache = L * batch * kv_row * (pos + 1) + L * batch * kv_row
    head = (d * c["vocab"] + d) * BF16_BYTES + batch * d * BF16_BYTES
    logits = batch * c["vocab"] * BF16_BYTES
    return float(L * layer + cache + head + logits)


def least_time_s(flops: float, nbytes: float) -> float:
    """The roofline's least time: the larger of flops over the bf16 peak
    and bytes over the memory rate."""
    return max(flops / BF16_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S)


def b3_bound(batch: int, hq: int, hkv: int, s: int, d: int
             ) -> tuple[float, str]:
    """Least time in seconds of one causal GQA attention call of B3 in bf16
    (``chip_smoke.py::b3_bound``): 4 B Hq D flops a visible pair over the
    bf16 peak, against q, k, v and o moved once; and which bounds it."""
    ops = 4 * batch * hq * d * visible_pairs(s) / BF16_FLOPS_PER_S
    q = batch * hq * s * d
    k = batch * hkv * s * d
    byt = (2 * q + 2 * k) * BF16_BYTES / HBM_BYTES_PER_S
    return (ops, "operations") if ops >= byt else (byt, "bytes")


def share(numerator: float, denominator: float) -> float | None:
    """100 x numerator / denominator, or None when there is nothing to
    divide by."""
    if not denominator or not math.isfinite(denominator):
        return None
    return 100.0 * numerator / denominator
