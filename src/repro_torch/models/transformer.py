"""Decoder-only LM family: GQA (optional QKV bias), RoPE, local:global
attention mixes, dense SwiGLU or MoE FFN; the training loss and KV-cache
serving.

Plain functions over a parameter tree that has the reference's layout:
``{"embed": (V, D), "final_norm": (D,), "layers": {name: (L, ...)},
"lm_head": (D, V)}`` (no ``lm_head`` when the embedding is tied), so the
JAX package's parameters carry across unchanged (``interop.lm_params``).
The layer loop is a Python loop with ``kind = pattern[i % len(pattern)]``,
which is the reference's scan over pattern periods plus the unrolled
remainder.  ``LMConfig`` has the reference's fields less its Pallas tile
size.

Training: ``forward`` returns ``(logits, aux)`` with gradients, aux the
MoE load-balance loss summed over the layers in layer order, and
``loss_fn`` is the cross-entropy plus ``0.01 * aux``.  The stacked layer
leaves are taken apart once with ``unbind(0)`` (indexing ``a[i]`` under
autograd would add a zero gradient of the whole ``(L, ...)`` leaf once a
layer).  With ``cfg.remat``, each layer runs under
``torch.utils.checkpoint`` (``remat_policy="full"`` keeps its input only;
``"dots"`` also keeps the outputs of the matmuls with no batch dimension,
``aten.mm``/``aten.addmm``, the counterpart of JAX's
``dots_with_no_batch_dims_saveable``).  The flash-attention kernel has no
backward, as the reference's Pallas kernel has no reverse mode, so
``use_flash_kernel`` under a gradient raises; training runs the plain
attention paths, as the reference's does.

MoE layers (``_moe_ffn``) route each token to its top-k experts with the
reference's capacity dispatch: ``C = max(1, int(capacity_factor * T * K /
E))`` slots an expert over the T tokens of the whole batch (so requests
share capacity, and a decode step of a few requests keeps about one token
an expert), slots ranked in token-major, then k, order, the rest dropped.
``moe_route`` is that routing on its own.

Serving: ``prefill`` runs the prompt through every layer (the flash
kernel when ``cfg.use_flash_kernel`` is set, else the plain attention
paths) and returns a KV cache and the last-token logits; ``decode_step``
appends one token.  Unlike the reference, ``decode_step`` writes the new
key and value into the cache in place (``index_copy_``), so a step does
not copy the whole cache.

Meshes: ``param_specs`` and ``cache_specs`` are the reference's specs of
the stacked leaves (Megatron tensor parallelism over "model", the batch
over the data axes).  The reference's ``shard`` annotations (the flat q /
k / v heads, the residual, the logits, the FFN, the expert buffer) are the
identity without a mesh; under ``common.use_mesh`` with ``DTensor`` inputs
(the dry run) they redistribute.  There attention runs on each rank's
(batch, head) block (``local_map``; heads over "model" when it divides the
kv heads, else replicated first, and merged back on each rank), the token
embedding of ``forward`` is ``common.take``'s per-block gather, decode
writes a sharded cache by the reference's one-hot select, the MoE routing,
dispatch and combine run replicated around the experts' matmuls (sharded
over the experts), and ``init_cache`` makes each rank's shard.
"""

from __future__ import annotations

import dataclasses
import math
from functools import partial
from typing import Any, Optional

import torch
from torch.utils.checkpoint import (CheckpointPolicy, checkpoint,
                                    create_selective_checkpoint_contexts)

from repro_torch.device import count_kept, resolve_device, span, traced
from repro_torch.kernels.decode_attention import ops as decode_ops
from repro_torch.kernels.decode_attention import ref as decode_ref
from repro_torch.kernels.flash_attention import ops as flash_ops
from repro_torch.models import attention as att
from repro_torch.models import common as cm
from repro_torch.models.common import P, dp_spec, shard

@dataclasses.dataclass(frozen=True)
class LMConfig:
    name: str = "lm"
    n_layers: int = 4
    d_model: int = 256
    n_q: int = 4
    n_kv: int = 2
    d_head: int = 64
    d_ff: int = 1024
    vocab: int = 1024
    qkv_bias: bool = False
    tie_embed: bool = False
    # attention pattern: tuple over one period, e.g. ("full",) or
    # ("local",)*5 + ("global",); "local" uses sliding window.
    pattern: tuple = ("full",)
    window: int = 1024
    rope_theta: float = 10_000.0
    rope_theta_local: float = 10_000.0
    # MoE (n_experts == 0 -> dense)
    n_experts: int = 0
    top_k: int = 2
    d_ff_expert: int = 0
    n_shared_experts: int = 0
    capacity_factor: float = 1.25
    # numerics / execution
    param_dtype: Any = torch.bfloat16
    compute_dtype: Any = torch.bfloat16
    norm_eps: float = 1e-6
    remat: bool = True
    remat_policy: str = "full"          # "full" | "dots" | "none"
    microbatches: int = 1
    # sequence-parallel residuals: the reference shards the residual's
    # sequence dim over its mesh; without a mesh its shard() is the
    # identity, so on one card this changes nothing
    seq_shard_activations: bool = False
    use_flash_kernel: bool = False       # the flash-attention kernel path
    attn_chunk: int = 1024               # > this seq len: chunked/banded attn

    @property
    def moe(self) -> bool:
        return self.n_experts > 0

    @property
    def n_periods(self) -> int:
        """Full periods of the attention pattern in the depth."""
        return self.n_layers // len(self.pattern)

    @property
    def n_remainder(self) -> int:
        """Layers after the last full period."""
        return self.n_layers % len(self.pattern)

    def param_count(self) -> int:
        d, dh = self.d_model, self.d_head
        attn = d * (self.n_q + 2 * self.n_kv) * dh + self.n_q * dh * d
        if self.qkv_bias:
            attn += (self.n_q + 2 * self.n_kv) * dh
        if self.moe:
            ff = self.n_experts * 3 * d * self.d_ff_expert + d * self.n_experts
            ff += self.n_shared_experts * 3 * d * self.d_ff_expert
        else:
            ff = 3 * d * self.d_ff
        per_layer = attn + ff + 2 * d
        emb = self.vocab * d * (1 if self.tie_embed else 2)
        return self.n_layers * per_layer + emb + d

    def active_param_count(self) -> int:
        """Parameters a token passes through: the routed top-k and the
        shared experts of each layer, the router, and the rest."""
        if not self.moe:
            return self.param_count()
        d = self.d_model
        dense_like = dataclasses.replace(self, n_experts=0,
                                         d_ff=0).param_count()
        ff_active = (self.top_k + self.n_shared_experts) * 3 * d \
            * self.d_ff_expert
        ff_active += d * self.n_experts  # router
        return dense_like + self.n_layers * ff_active


# ---------------------------------------------------------------------------
# Parameters
# ---------------------------------------------------------------------------

def init_params(gen: torch.Generator, cfg: LMConfig) -> dict:
    """Random parameters on the generator's device, in the reference's
    layout: a MoE layer has a float32 ``router`` (d, E), experts
    ``we_gate``/``we_up`` (E, d, fe) and ``we_down`` (E, fe, d), and shared
    experts ``ws_*`` of width ``fe * n_shared_experts``.  Stacked (L, ...)
    arrays are drawn one layer at a time in float32, so the float32 peak is
    one layer's widest tensor."""
    L, d, dh = cfg.n_layers, cfg.d_model, cfg.d_head
    pd, dev = cfg.param_dtype, gen.device

    def stacked(shape, dtype=pd):
        out = torch.empty((L,) + shape, dtype=dtype, device=dev)
        for i in range(L):
            out[i] = cm.dense_init(gen, shape, dtype=dtype)
        return out

    layers = {
        "ln1": torch.zeros((L, d), dtype=pd, device=dev),
        "ln2": torch.zeros((L, d), dtype=pd, device=dev),
        "wq": stacked((d, cfg.n_q * dh)),
        "wk": stacked((d, cfg.n_kv * dh)),
        "wv": stacked((d, cfg.n_kv * dh)),
        "wo": stacked((cfg.n_q * dh, d)),
    }
    if cfg.qkv_bias:
        layers["bq"] = torch.zeros((L, cfg.n_q * dh), dtype=pd, device=dev)
        layers["bk"] = torch.zeros((L, cfg.n_kv * dh), dtype=pd, device=dev)
        layers["bv"] = torch.zeros((L, cfg.n_kv * dh), dtype=pd, device=dev)
    if cfg.moe:
        E, fe = cfg.n_experts, cfg.d_ff_expert
        layers["router"] = stacked((d, E), dtype=torch.float32)
        layers["we_gate"] = stacked((E, d, fe))
        layers["we_up"] = stacked((E, d, fe))
        layers["we_down"] = stacked((E, fe, d))
        if cfg.n_shared_experts:
            fs = fe * cfg.n_shared_experts
            layers["ws_gate"] = stacked((d, fs))
            layers["ws_up"] = stacked((d, fs))
            layers["ws_down"] = stacked((fs, d))
    else:
        layers["w_gate"] = stacked((d, cfg.d_ff))
        layers["w_up"] = stacked((d, cfg.d_ff))
        layers["w_down"] = stacked((cfg.d_ff, d))
    params = {
        "embed": cm.embed_init(gen, (cfg.vocab, d), dtype=pd),
        "final_norm": torch.zeros((d,), dtype=pd, device=dev),
        "layers": layers,
    }
    if not cfg.tie_embed:
        params["lm_head"] = cm.dense_init(gen, (d, cfg.vocab), dtype=pd)
    return params


def param_specs(cfg: LMConfig) -> dict:
    """Specs mirroring ``init_params``' stacked leaves (Megatron tensor
    parallelism over "model")."""
    layers = {
        "ln1": P(None, None),
        "ln2": P(None, None),
        "wq": P(None, None, "model"),
        "wk": P(None, None, "model"),
        "wv": P(None, None, "model"),
        "wo": P(None, "model", None),
    }
    if cfg.qkv_bias:
        layers |= {"bq": P(None, "model"), "bk": P(None, "model"),
                   "bv": P(None, "model")}
    if cfg.moe:
        layers |= {
            "router": P(None, None, None),
            "we_gate": P(None, "model", None, None),
            "we_up": P(None, "model", None, None),
            "we_down": P(None, "model", None, None),
        }
        if cfg.n_shared_experts:
            layers |= {
                "ws_gate": P(None, None, "model"),
                "ws_up": P(None, None, "model"),
                "ws_down": P(None, "model", None),
            }
    else:
        layers |= {
            "w_gate": P(None, None, "model"),
            "w_up": P(None, None, "model"),
            "w_down": P(None, "model", None),
        }
    specs = {"embed": P("model", None), "final_norm": P(None),
             "layers": layers}
    if not cfg.tie_embed:
        specs["lm_head"] = P(None, "model")
    return specs


def _layer(params: dict, i: int) -> dict:
    return {k: a[i] for k, a in params["layers"].items()}


def _kind(cfg: LMConfig, i: int) -> str:
    return cfg.pattern[i % len(cfg.pattern)]


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def _attention_full(q, k, v, positions_q, positions_kv, window):
    """Reference-path attention: (B, S, H, D) layout; causal (+window)."""
    dh = q.shape[3]
    group = q.shape[2] // k.shape[2]
    kf = k.repeat_interleave(group, dim=2)
    vf = v.repeat_interleave(group, dim=2)
    scale = 1.0 / math.sqrt(dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", q.float(), kf.float()) * scale
    mask = positions_kv[:, None, :] <= positions_q[:, :, None]  # (B, Sq, Skv)
    if window is not None:
        mask &= positions_kv[:, None, :] > positions_q[:, :, None] - window
    logits = torch.where(mask[:, None], logits, -1e30)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", probs, vf.float())
    return out.to(q.dtype)


def _decode_attention(q, ck, cv, pos, window):
    """Attention of each row's new token over its cache: B5
    (``kernels/decode_attention``) on a plain cache, on the card (its plain
    version on the CPU); on a ``DTensor`` cache the plain version's two
    matmuls on permuted views, no KV repeat.

    q: (B, 1, Hq, D); ck/cv: (B, S, Hkv, D); pos: (B,) current position.
    """
    if cm.is_dtensor(ck):
        # under a mesh the query's heads are replicated: the cache's
        # sequence carries the "model" sharding
        q = shard(q, cm.batch_spec(q.shape[0], None, None, None))
        return decode_ref.decode_attention(q, ck, cv, pos, window)
    return decode_ops.decode_attention(q, ck, cv, pos, window)


def _attention(q, k, v, positions_q, positions_kv, window, cfg):
    if cfg.use_flash_kernel and q.shape[1] == k.shape[1]:
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                        or v.requires_grad):
            raise ValueError(
                "use_flash_kernel=True under a gradient: the flash-attention "
                "kernel has no backward, as the JAX package's Pallas kernel "
                "has no reverse mode; train with use_flash_kernel=False "
                "(the plain attention paths)")
        o = flash_ops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                                      v.transpose(1, 2), causal=True,
                                      window=window)
        return o.transpose(1, 2)
    if cm.is_dtensor(q):
        return _sharded_attention(q, k, v, positions_q, positions_kv, window,
                                  cfg)
    return _plain_attention(q, k, v, positions_q, positions_kv, window, cfg)


def _sharded_attention(q, k, v, positions_q, positions_kv, window, cfg):
    """Attention on ``DTensor``s, on each rank's (batch, head) block
    (``local_map``, the reference's per-shard attention): the batch over
    the data axes, the heads over "model" when it divides the kv heads,
    else replicated over it.  The positions are one row's (every row of a
    training or prefill batch has the same).  Returns (B, S, Hq * D), the
    heads merged on each rank, so the backward splits no sharded dim."""
    from torch.distributed.tensor.experimental import local_map

    mesh = q.device_mesh
    model = cm.mesh_axis_size("model")
    heads = "model" if cfg.n_kv % model == 0 else None
    pl = cm.placements(mesh, cm.batch_spec(q.shape[0], None, heads, None))
    flat = cm.placements(mesh, cm.batch_spec(q.shape[0], None, heads))
    pq, pk = positions_q[:1], positions_kv[:1]

    def local(q, k, v):
        o = _plain_attention(q, k, v, pq, pk, window, cfg)
        return o.reshape(o.shape[0], o.shape[1], -1)

    return local_map(local, out_placements=flat, in_placements=(pl, pl, pl),
                     device_mesh=mesh, redistribute_inputs=True)(q, k, v)


def _plain_attention(q, k, v, positions_q, positions_kv, window, cfg):
    s = q.shape[1]
    if s > cfg.attn_chunk and s == k.shape[1]:
        if window is not None:
            return att.banded_attention(q, k, v, window=window,
                                        q_chunk=cfg.attn_chunk)
        return att.chunked_attention(q, k, v, causal=True,
                                     q_chunk=cfg.attn_chunk,
                                     k_chunk=cfg.attn_chunk)
    return _attention_full(q, k, v, positions_q, positions_kv, window)


def _heads(t, b, s, n, dh):
    """(B, S, n * dh) -> (B, S, n, dh).  Under a mesh the heads stay over
    "model" only when it divides n; else they are replicated first (a
    sharded dim is not split across heads)."""
    if n % cm.mesh_axis_size("model"):
        t = shard(t, cm.batch_spec(b, None, None))
    return t.reshape(b, s, n, dh)


@traced("lm.attn")
def _attn_block(x, lp, kind, positions, cfg, cache=None, cache_pos=None):
    """x: (B, S, D).  Returns (out, (k, v)): the new keys and values, or
    the cache (ck, cv) after writing them at ``cache_pos`` in place."""
    b, s, _ = x.shape
    dh = cfg.d_head
    h = cm.rms_norm(x, lp["ln1"], cfg.norm_eps)
    q = h @ lp["wq"]
    k = h @ lp["wk"]
    v = h @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    # the flat head dim over "model" (head counts need not divide it)
    q = shard(q, dp_spec(None, "model"))
    k = shard(k, dp_spec(None, "model"))
    v = shard(v, dp_spec(None, "model"))
    q = _heads(q, b, s, cfg.n_q, dh)
    k = _heads(k, b, s, cfg.n_kv, dh)
    v = _heads(v, b, s, cfg.n_kv, dh)
    theta = cfg.rope_theta_local if kind == "local" else cfg.rope_theta
    q = cm.apply_rope(q, positions, theta)
    k = cm.apply_rope(k, positions, theta)
    window = cfg.window if kind == "local" else None
    if cache is None:
        with span("lm.attn.core"):
            o = _attention(q, k, v, positions, positions, window, cfg)
        new_kv = (k, v)
    else:
        ck, cv = cache                      # (B, Smax, n_kv, dh)
        if cm.is_dtensor(ck):
            # a sharded cache: the reference's shard-local one-hot select
            # along the (model-sharded) seq dim, written back in place
            sel = (torch.arange(ck.shape[1], device=ck.device)
                   == cache_pos)[None, :, None, None]
            ck.copy_(torch.where(sel, k.to(ck.dtype), ck))
            cv.copy_(torch.where(sel, v.to(cv.dtype), cv))
        else:
            ck.index_copy_(1, cache_pos, k.to(ck.dtype))
            cv.index_copy_(1, cache_pos, v.to(cv.dtype))
        with span("lm.attn.core"):
            o = _decode_attention(q, ck, cv, positions[:, -1], window)
        new_kv = (ck, cv)
    o = o.reshape(b, s, cfg.n_q * dh)
    return o @ lp["wo"], new_kv


# ---------------------------------------------------------------------------
# FFN
# ---------------------------------------------------------------------------

def _dense_ffn(x, lp, cfg):
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    g = shard(h @ lp["w_gate"], dp_spec(None, "model"))
    return cm.swiglu(g, h @ lp["w_up"]) @ lp["w_down"]


@dataclasses.dataclass
class Routing:
    """One MoE layer's routing of T tokens to K of E experts."""
    probs: torch.Tensor      # (T, E) float32 router softmax
    topw: torch.Tensor       # (T, K) float32 weights, summing to 1 a token
    tope: torch.Tensor       # (T, K) int64 experts, descending probability
    slot: torch.Tensor       # (T*K,) int64 row of the (E*C + 1)-row buffer
    keep: torch.Tensor       # (T*K,) bool: the slot fits its expert
    load: torch.Tensor       # (E,) int64 slots routed to each expert
    capacity: int            # C, slots an expert


def moe_route(xt: torch.Tensor, router: torch.Tensor,
              cfg: LMConfig) -> Routing:
    """The reference's routing (``repro.models.transformer._moe_ffn``):
    float32 router softmax, top-k, weights renormalised, and each slot
    (token t's k-th expert, flat index t*K + k) ranked within its expert
    by the slots before it in that flat order (exclusive cumsum of the
    one-hot).  A slot ranked below C goes to row ``e*C + rank``; every
    other slot to the discarded row ``E*C``.  The one-hot is laid out
    (E, T*K), so the cumsum runs along its last dim: along dim 0 of the
    (T*K, E) layout a CUDA scan walks each of the E columns in one thread."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * T * K / E))
    probs = torch.softmax(xt.float() @ router.float(), dim=-1)
    topw, tope = torch.topk(probs, K, dim=-1)
    topw = topw / topw.sum(-1, keepdim=True).clamp_min(1e-9)
    fe = tope.reshape(-1)
    oh = (fe == torch.arange(E, device=fe.device)[:, None]).long()
    seen = oh.cumsum(1)
    rank = (seen - oh).gather(0, fe[None])[0]
    keep = rank < C
    slot = torch.where(keep, fe * C + rank, E * C)
    return Routing(probs, topw, tope, slot, keep, seen[:, -1], C)


def _route(xt, router, cfg) -> Routing:
    """``moe_route``; on ``DTensor``s it runs replicated (its top-k, ranks
    and gathers have no ``DTensor`` rule on the card's torch)."""
    if not cm.is_dtensor(xt):
        return moe_route(xt, router, cfg)
    capacity = max(1, int(cfg.capacity_factor * xt.shape[0] * cfg.top_k
                          / cfg.n_experts))

    def local(xt, router):
        r = moe_route(xt, router, cfg)
        return r.probs, r.topw, r.tope, r.slot, r.keep, r.load

    return Routing(*cm.replicated(local, xt, router), capacity)


def _moe_ffn(x, lp, cfg):
    """Top-k capacity dispatch into an (E, C, d) buffer, the experts as
    batched matmuls over E, shared experts on the normed rows.  Returns
    (out (B, S, d), aux): aux is the Switch load-balance loss ``E *
    sum(mean(probs) * bincount(experts) / (T*K))`` over every routed slot,
    kept or dropped.

    While a profiler records, the routing, dispatch, experts, combine and
    shared experts are spans ``lm.moe.*``, and inside a traced serving
    phase the slots kept count there (``device.count_kept`` keeps the
    routing's own ``keep`` mask); nothing is counted on ``DTensor``s.

    Each kept slot's row is copied into its buffer row (``index_copy_``;
    only the discarded row ``E*C`` takes several), so the dispatch is exact.
    The combine adds a token's K weighted expert rows one after another in
    the compute dtype, rounding after each addition, as the reference's
    scatter-add into a zero row of that dtype does when it applies the K
    updates in order (``ft`` repeats each token K times, so they are
    adjacent); no atomics.  Nothing here reads the device from the host."""
    b, s, d = x.shape
    h = cm.rms_norm(x, lp["ln2"], cfg.norm_eps)
    T = b * s
    xt = h.reshape(T, d)
    E, K = cfg.n_experts, cfg.top_k
    with span("lm.moe.route"):
        r = _route(xt, lp["router"], cfg)
    C = r.capacity
    if not cm.is_dtensor(xt):
        count_kept(r.keep)
    with span("lm.moe.dispatch"):
        ft = torch.arange(T * K, device=x.device) // K
        # the dispatch runs replicated under a mesh (the buffer is then
        # sharded over the experts)
        buf = cm.replicated(lambda xt, slot, ft: xt.new_zeros(
            (E * C + 1, d)).index_copy_(0, slot, xt[ft]), xt, r.slot, ft)
    expert = P("model", None, None)
    with span("lm.moe.experts"):
        xe = shard(buf[:E * C].view(E, C, d), expert)
        g = shard(torch.bmm(xe, lp["we_gate"]), expert)
        u = shard(torch.bmm(xe, lp["we_up"]), expert)
        y = shard(torch.bmm(cm.swiglu(g, u), lp["we_down"]),
                  expert).reshape(E * C, d)
    with span("lm.moe.combine"):
        contrib = cm.replicated(lambda y, slot, topw: (
            torch.cat([y, y.new_zeros((1, d))])[slot]
            * topw.reshape(-1, 1).to(y.dtype)).view(T, K, d),
            y, r.slot, r.topw)
        out = contrib[:, 0]
        for k in range(1, K):
            out = out + contrib[:, k]
    if cfg.n_shared_experts:
        with span("lm.moe.shared"):
            out = out + cm.swiglu(xt @ lp["ws_gate"],
                                  xt @ lp["ws_up"]) @ lp["ws_down"]
    aux = E * torch.sum(r.probs.mean(0) * (r.load.float() / (T * K)))
    return out.reshape(b, s, d), aux


def _ffn(x, lp, cfg):
    """(out, aux): the MoE load-balance loss, None for a dense FFN."""
    return _moe_ffn(x, lp, cfg) if cfg.moe else (_dense_ffn(x, lp, cfg), None)


@traced("lm.logits")
def _logits(params, x, cfg):
    x = cm.rms_norm(x, params["final_norm"], cfg.norm_eps)
    head = params["embed"].T if cfg.tie_embed else params["lm_head"]
    return shard(x @ head.to(cfg.compute_dtype), dp_spec(None, "model"))


def _residual_spec(cfg):
    return dp_spec("model", None) if cfg.seq_shard_activations \
        else dp_spec(None, None)


# ---------------------------------------------------------------------------
# Forward and serving
# ---------------------------------------------------------------------------

def _tokens(tokens, device) -> torch.Tensor:
    """The token ids as a tensor on ``device`` (None: the CUDA card)."""
    return torch.as_tensor(tokens, device=resolve_device(device))


def _unbound_layers(params: dict) -> list:
    """Every layer's parameter dict, each stacked leaf taken apart once by
    ``unbind(0)``, whose backward stacks the L gradients once."""
    names = list(params["layers"])
    cols = zip(*(params["layers"][k].unbind(0) for k in names))
    return [dict(zip(names, c)) for c in cols]


def _layer_fwd(x, lp, kind, positions, cfg):
    a, _ = _attn_block(x, lp, kind, positions, cfg)
    x = shard(x + a, _residual_spec(cfg))
    f, aux = _ffn(x, lp, cfg)
    return shard(x + f, _residual_spec(cfg)), aux


_SAVED_DOTS = (torch.ops.aten.mm.default, torch.ops.aten.addmm.default)


def _dots_policy(ctx, op, *args, **kwargs):
    return (CheckpointPolicy.MUST_SAVE if op in _SAVED_DOTS
            else CheckpointPolicy.PREFER_RECOMPUTE)


def _apply_layer(x, lp, kind, positions, cfg):
    if cfg.remat and cfg.remat_policy != "none" and torch.is_grad_enabled():
        kw = {}
        if cfg.remat_policy == "dots":
            kw["context_fn"] = partial(create_selective_checkpoint_contexts,
                                       _dots_policy)
        return checkpoint(_layer_fwd, x, lp, kind, positions, cfg,
                          use_reentrant=False, **kw)
    return _layer_fwd(x, lp, kind, positions, cfg)


def forward(params, tokens, cfg: LMConfig, positions=None, *, device=None):
    """tokens (B, S) -> (logits (B, S, V), aux), with gradients when they
    are enabled; aux is the MoE load-balance loss summed over the layers
    (0 for dense FFNs).  Runs on ``device`` (None: the CUDA card), where
    the parameters lie."""
    tokens = _tokens(tokens, device)
    b, s = tokens.shape
    if positions is None:
        positions = torch.arange(s, dtype=torch.int32,
                                 device=tokens.device).expand(b, s)
    x = shard(cm.take(params["embed"].to(cfg.compute_dtype), tokens),
              _residual_spec(cfg))
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i, lp in enumerate(_unbound_layers(params)):
        x, aux_i = _apply_layer(x, lp, _kind(cfg, i), positions, cfg)
        if aux_i is not None:
            aux = aux + aux_i
    return _logits(params, x, cfg), aux


def loss_fn(params, batch: dict, cfg: LMConfig, *, device=None):
    """``(loss + 0.01 * aux, {"loss": loss, "aux": aux})``: the token-mean
    cross-entropy of ``batch["tokens"]`` against ``batch["labels"]`` (with
    ``batch["mask"]`` when given) plus the MoE load-balance loss."""
    logits, aux = forward(params, batch["tokens"], cfg, device=device)
    labels = torch.as_tensor(batch["labels"], device=logits.device)
    mask = batch.get("mask")
    if mask is not None:
        mask = torch.as_tensor(mask, device=logits.device)
    loss = cm.cross_entropy(logits, labels, mask)
    return loss + 0.01 * aux, {"loss": loss, "aux": aux}


def init_cache(cfg: LMConfig, batch: int, max_seq: int, dtype=None,
               device=None) -> dict:
    """A zero cache on ``device``, k and v in ``dtype`` (None:
    ``cfg.compute_dtype``); under a mesh, ``DTensor``s placed by
    ``cache_specs`` (each rank allocates its own shard)."""
    dev = resolve_device(device)
    dtype = dtype or cfg.compute_dtype
    shape = (cfg.n_layers, batch, max_seq, cfg.n_kv, cfg.d_head)
    kinds = {"k": (shape, dtype), "v": (shape, dtype),
             "pos": ((batch,), torch.int32)}
    mesh = cm.current_mesh()
    if mesh is not None:
        specs = cache_specs(cfg)
        return {k: cm.sharded_zeros(sh, dt, dev, specs[k])
                for k, (sh, dt) in kinds.items()}
    return {k: torch.zeros(sh, dtype=dt, device=dev)
            for k, (sh, dt) in kinds.items()}


def cache_specs(cfg: LMConfig, long_context: bool = False) -> dict:
    """Specs of ``init_cache``'s leaves: batch over the data axes and the
    sequence over "model"; a long context (batch too small to shard) puts
    the sequence over ("data", "model")."""
    if long_context:
        seq = ("data", "model")
        return {"k": P(None, None, seq, None, None),
                "v": P(None, None, seq, None, None), "pos": P()}
    return {"k": P(None, ("pod", "data"), "model", None, None),
            "v": P(None, ("pod", "data"), "model", None, None),
            "pos": P(("pod", "data"))}


@torch.no_grad()
@traced("lm.prefill", phase="prefill")
def prefill(params, tokens, cfg: LMConfig, max_seq: Optional[int] = None, *,
            device=None):
    """Returns (cache filled for s positions, last-token logits (B, V)).
    Runs on ``device`` (None: the CUDA card), where the parameters lie."""
    tokens = _tokens(tokens, device)
    b, s = tokens.shape
    if max_seq is None:
        max_seq = s
    elif max_seq < s:
        raise ValueError(f"max_seq={max_seq} is shorter than the prompt "
                         f"(s={s}); the cache would truncate live tokens")
    positions = torch.arange(s, dtype=torch.int32,
                             device=tokens.device).expand(b, s)
    x = shard(params["embed"].to(cfg.compute_dtype)[tokens],
              _residual_spec(cfg))
    cache = init_cache(cfg, b, max_seq, device=tokens.device)
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        a, (k, v) = _attn_block(x, lp, _kind(cfg, i), positions, cfg)
        if s == max_seq:        # the whole sequence (a sharded one too)
            cache["k"][i].copy_(k)
            cache["v"][i].copy_(v)
        else:
            cache["k"][i, :, :s] = k
            cache["v"][i, :, :s] = v
        x = shard(x + a, _residual_spec(cfg))
        x = shard(x + _ffn(x, lp, cfg)[0], _residual_spec(cfg))
    cache["pos"].fill_(s)
    return cache, _logits(params, x[:, -1:], cfg)[:, 0]


@torch.no_grad()
@traced("lm.decode_step", phase="decode")
def decode_step(params, cache, tokens, cfg: LMConfig, *, device=None):
    """One decode step: tokens (B,) -> (cache, logits (B, V)).  The cache's
    keys and values are updated in place; ``pos`` is a new tensor.  Runs on
    ``device`` (None: the CUDA card), where the parameters and cache lie."""
    tokens = _tokens(tokens, device)
    pos = cache["pos"]                                   # (B,)
    positions = pos[:, None]                             # (B, 1)
    x = params["embed"].to(cfg.compute_dtype)[tokens[:, None]]
    cache_pos = pos[:1].long()                           # uniform batch pos
    for i in range(cfg.n_layers):
        lp = _layer(params, i)
        a, _ = _attn_block(x, lp, _kind(cfg, i), positions, cfg,
                           cache=(cache["k"][i], cache["v"][i]),
                           cache_pos=cache_pos)
        x = x + a
        x = x + _ffn(x, lp, cfg)[0]
    logits = _logits(params, x, cfg)[:, 0]
    return {"k": cache["k"], "v": cache["v"], "pos": pos + 1}, logits
