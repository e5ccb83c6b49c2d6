"""The one traffic generator: batches of prompts drawn from the seed, by
the parameters of a traffic file (``bench/traffic/<name>.json``):

- ``loop``: ``"closed"``, one client that sends its next batch when the
  last one has been served;
- ``batch``: requests a batch;
- ``prompt_len``: tokens a prompt, a number, or a list that batch i takes
  entry ``i % len`` of (every request of a batch has the same length);
- ``new_tokens``: greedy tokens a request gets (0: only the first token,
  the argmax of the prefill's logits); ``max_seq``: the cache's length;
- ``ids``: how prompt ids are drawn: ``"uniform"`` over the vocabulary,
  or ``"zipf"``: over the first ``vocab_share`` of the vocabulary, id r
  with weight ``1 / (r + 1) ** zipf_s``.

Batch i of a run is drawn on the device from a generator seeded with a
mix of the run's seed and i, so any batch can be drawn again, and every
seed gives the same sizes in the same order.
"""

from __future__ import annotations

import torch

WARMUP = 2 ** 40          # the batch index of the warm-up's prompts
_MASK = 2 ** 64 - 1
IDS = ("uniform", "zipf")


def mix(seed: int, i: int) -> int:
    """A 63-bit seed for batch i of a run seeded with ``seed``
    (splitmix64 of the pair)."""
    z = (seed * 0x9E3779B97F4A7C15 + i + 1) & _MASK
    z = ((z ^ (z >> 30)) * 0xBF58476D1CE4E5B9) & _MASK
    z = ((z ^ (z >> 27)) * 0x94D049BB133111EB) & _MASK
    return (z ^ (z >> 31)) >> 1


def lengths(traffic: dict) -> list:
    """The prompt lengths the traffic cycles through, in batch order."""
    n = traffic["prompt_len"]
    return list(n) if isinstance(n, list) else [n]


def prompt_len(traffic: dict, i: int) -> int:
    """The prompt length of batch i."""
    cycle = lengths(traffic)
    return cycle[i % len(cycle)]


def check(traffic: dict) -> None:
    """Raise on a traffic file this generator cannot serve."""
    if traffic.get("loop") != "closed":
        raise ValueError(f"loop {traffic.get('loop')!r}: only a closed loop "
                         f"is generated")
    if traffic.get("ids") not in IDS:
        raise ValueError(f"ids {traffic.get('ids')!r}: one of {IDS}")
    if traffic["ids"] == "zipf" and not (
            0 < traffic["vocab_share"] <= 1 and traffic["zipf_s"] > 0):
        raise ValueError("zipf ids need 0 < vocab_share <= 1, zipf_s > 0")
    if not lengths(traffic) or min(lengths(traffic)) < 1:
        raise ValueError("prompt_len: one or more lengths of at least 1")
    if max(lengths(traffic)) + traffic["new_tokens"] > traffic["max_seq"]:
        raise ValueError("prompt_len + new_tokens exceeds max_seq")


def prompts(traffic: dict, vocab: int, seed: int, i: int,
            device) -> torch.Tensor:
    """Batch i's prompts, (batch, prompt_len(i)) int32 on ``device``."""
    gen = torch.Generator(device=device).manual_seed(mix(seed, i))
    shape = (traffic["batch"], prompt_len(traffic, i))
    if traffic.get("ids", "uniform") == "uniform":
        return torch.randint(0, vocab, shape, generator=gen, device=device,
                             dtype=torch.int32)
    n = max(1, int(traffic["vocab_share"] * vocab))
    ranks = torch.arange(1, n + 1, dtype=torch.float32, device=device)
    weights = ranks.pow(-float(traffic["zipf_s"]))
    ids = torch.multinomial(weights, shape[0] * shape[1], replacement=True,
                            generator=gen)
    return ids.view(shape).to(torch.int32)
