"""Batched serving: prefill + greedy decode with a KV cache.

``python -m repro_torch.launch.serve --device cpu --arch gemma3-4b
--requests 8 --new-tokens 16``

A batch of requests is prefilled once, then decoded step by step (greedy).
The CLI runs the reduced config (``configs/reduced.py``) with parameters
drawn from a generator seeded with 0, on the CUDA card unless ``--device``
says otherwise; a MoE arch (``--arch moonshot-v1-16b-a3b`` or
``phi3.5-moe-42b-a6.6b``) serves the same way.  :func:`generate` is the
loop itself, at any width.

Tracing: while a ``torch.profiler.profile`` records, and only then, the
serving path marks spans on the profiler's host timeline
(``repro_torch.device.span``; no environment variable or flag) and counts
its MoE slots (``device.count``):

- ``serve.generate`` one :func:`generate` call, ``serve.step`` each of its
  decode iterations, ``serve.wait`` each ``host_read`` that waits for the
  card;
- ``lm.prefill`` and ``lm.decode_step`` the model's calls; inside them
  ``lm.attn`` (an attention block), ``lm.attn.core`` (the attention itself,
  the cache write outside it), ``lm.moe.route``, ``lm.moe.dispatch``,
  ``lm.moe.experts`` (the three expert matmuls and the SwiGLU),
  ``lm.moe.combine``, ``lm.moe.shared`` and ``lm.logits``;
- per phase (``"prefill"``, ``"decode"``), the MoE slots kept (the
  routings' ``keep`` masks, summed on the card), brought to the host by
  ``device.read_counters()`` after the profiler stops
  (``device.reset_counters()`` empties them); the slots routed, T*K a MoE
  layer call, and the buffer rows, E*C, follow from the shapes.

Each span launches nothing and waits for nothing, so the served tokens and
logits are the same bits with the profiler on or off.
"""

from __future__ import annotations

import argparse
import dataclasses
import time

import numpy as np
import torch

from repro_torch.configs import registry
from repro_torch.configs.reduced import reduced_lm
from repro_torch.device import host_read, resolve_device, span, traced
from repro_torch.models import transformer as T


@dataclasses.dataclass
class Generation:
    tokens: np.ndarray             # (B, new_tokens) int32 greedy tokens
    prefill_logits: torch.Tensor   # (B, V) last-token logits of the prompt
    logits: torch.Tensor           # (B, V) logits of the last decode step
    prefill_s: float               # host wall of the prefill, synchronised
    decode_s: float                # host wall of the decode steps


@traced("serve.generate")
def generate(params, prompts, cfg: T.LMConfig, new_tokens: int,
             max_seq: int, *, device=None) -> Generation:
    """Prefill ``prompts`` (B, S), then ``new_tokens`` greedy decode steps:
    the first token is the argmax of the prefill's logits and each step
    feeds the last token back.  Raises when any logits are not finite.
    The device is waited on twice, after the prefill and at the end (both
    through ``host_read``, each in a span ``serve.wait``)."""
    dev = resolve_device(device)
    prompts = torch.as_tensor(prompts, device=dev)
    t0 = time.perf_counter()
    cache, prefill_logits = T.prefill(params, prompts, cfg, max_seq=max_seq,
                                      device=dev)
    ok = torch.isfinite(prefill_logits).all()
    with span("serve.wait"):
        (finite,) = host_read(ok)
    t1 = time.perf_counter()
    logits = prefill_logits
    tok = logits.argmax(-1).to(torch.int32)
    all_finite = torch.isfinite(logits).all()
    out = []
    for _ in range(new_tokens):
        with span("serve.step"):
            out.append(tok)
            cache, logits = T.decode_step(params, cache, tok, cfg,
                                          device=dev)
            all_finite &= torch.isfinite(logits).all()
            tok = logits.argmax(-1).to(torch.int32)
    with span("serve.wait"):
        (finite_decode,) = host_read(all_finite)
    t2 = time.perf_counter()
    if not (finite and finite_decode):
        raise RuntimeError("non-finite logits in the prefill or a decode "
                           "step: the served checkpoint or kernel path is "
                           "broken")
    tokens = (torch.stack(out, 1) if out else
              torch.zeros((prompts.shape[0], 0), dtype=torch.int32))
    return Generation(tokens.cpu().numpy(), prefill_logits, logits,
                      t1 - t0, t2 - t1)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="gemma3-4b", choices=registry.LM_ARCHS)
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--new-tokens", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the CUDA card)")
    args = ap.parse_args(argv)

    dev = resolve_device(args.device)
    cfg = reduced_lm(registry.get_config(args.arch))
    params = T.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    rng = np.random.default_rng(0)
    prompts = rng.integers(0, cfg.vocab,
                           (args.requests, args.prompt_len)).astype(np.int32)
    gen = generate(params, prompts, cfg, args.new_tokens,
                   args.prompt_len + args.new_tokens, device=dev)
    print(f"[serve] {args.arch} on {dev}: {args.requests} requests, "
          f"prefill {args.prompt_len} toks in {gen.prefill_s * 1e3:.1f} ms, "
          f"{args.new_tokens} decode steps in {gen.decode_s * 1e3:.1f} ms "
          f"({args.requests * args.new_tokens / max(gen.decode_s, 1e-9):.0f}"
          f" tok/s)")
    print("[serve] first request generation:", gen.tokens[0].tolist())


if __name__ == "__main__":
    main()
