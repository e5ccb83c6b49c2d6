"""What decides ``correct``: the tokens the timed path served, judged by
the plain float32 reference (``reference/lm.py``).

Once the window has closed, a sample of its batches is drawn from the seed
(a batch and not a request, since requests of one batch share the experts'
capacity).  The reference runs once over each sampled batch's prompts and
served tokens, and reads at each served position by how much the served
token's logit lies below its best logit (the gap), and for each request
the relative error of the prefill's last-token logits.  A cell's file
limits one or both of two numbers (``NUMBERS``): ``gap_mean``, the mean
gap over every served token checked, and ``logit_err_median``, the median
relative error over every request checked.  A failed batch fails the run.
The control reads the same for the reference in fp8.

Why no widest gap: with random weights the best two logits of a position
often lie close, and a routing decision that rounds the other way (a near
tie in the top-k, or a slot at an expert's capacity, which the last tokens
of a batch reach first) changes a token's layer output.  Such flips are
rare in bf16 and set the widest gap over a run as they do in fp8, so the
widest gap did not separate the program from the control (PERF.md).
"""

from __future__ import annotations

import random

import torch

from bench import traffic as tr
from bench.reference import lm as ref


def sample(n_batches: int, k: int, seed: int) -> list:
    """Indices of the batches to check: k of n drawn from the seed."""
    return sorted(random.Random(seed).sample(range(n_batches),
                                             min(k, n_batches)))


def sequences(traffic: dict, vocab: int, seed: int, index: int,
              served: torch.Tensor, device) -> tuple:
    """(tokens (B, N), prompt length, positions) of one batch: the prompts
    and every served token but the last, the batch's prompt length, and
    the positions whose logits chose the served tokens (the prompt's last,
    then one a token)."""
    prompts = tr.prompts(traffic, vocab, seed, index, device)
    s, p = prompts.shape[1], served.shape[1]
    tokens = torch.cat([prompts, served[:, :p - 1].to(device, prompts.dtype)],
                       dim=1)
    return tokens, s, list(range(s - 1, s - 1 + p))


def readings(params: dict, port: dict, traffic: dict, seed: int,
             index: int, served: torch.Tensor, device, logits=None,
             control: bool = False) -> dict:
    """What one batch reads, flat on the host: ``gap``, the gap of every
    served token; with the program's last-token logits of its prefill
    (``logits``, (B, V)), ``err``, each request's relative error of them
    against the reference's (``ref.relative_error``).  With ``control``
    also ``gap_control``, the gap of each token the reference in fp8 puts
    first at the same positions, and ``err_control``, the fp8 reference's
    own last-token logits' error."""
    tokens, s, positions = sequences(traffic, port["vocab"], seed, index,
                                     served, device)
    hidden = ref.final_hidden(params, port, tokens, s, positions)
    out = {"gap": ref.gaps(params, hidden, served.to(device))}
    if logits is not None:
        out["err"] = ref.relative_error(params, hidden[:, 0], logits)
    if control:
        low = ref.final_hidden(params, port, tokens, s, positions,
                               quant="fp8")
        out["gap_control"] = ref.gaps(params, hidden,
                                      ref.argmax_tokens(params, low, "fp8"))
        out["err_control"] = ref.relative_error(
            params, hidden[:, 0], ref.head_logits(params, low[:, 0], "fp8"))
    return {k: v.flatten().cpu() for k, v in out.items()}


def control_view(readings: dict) -> dict:
    """The control's readings under the program's names, so that ``judge``
    reads the control as it reads a run."""
    return {"gap": readings["gap_control"], "err": readings["err_control"]}


# The numbers a cell's file may set limits on, from a run's readings (the
# readings of its checked batches, concatenated).
NUMBERS = {
    "gap_mean": lambda r: float(r["gap"].double().mean()),
    "logit_err_median": lambda r: float(r["err"].double().median()),
}


def judge(readings: list, failed: int, limits: dict) -> tuple:
    """(correct, checks) of a run's checked batches: each number the cell
    limits, with its limit and which side of it passes, then the failed
    requests and the batches checked."""
    checks = {}
    if readings:
        joined = {k: torch.cat([r[k] for r in readings]) for k in readings[0]}
        for name, limit in limits.items():
            checks[name] = {"value": NUMBERS[name](joined), "limit": limit,
                            "pass": "<="}
    checks["failed"] = {"value": failed, "limit": 0, "pass": "<="}
    checks["batches_checked"] = {"value": len(readings), "limit": 1,
                                 "pass": ">="}
    correct = all(c["value"] <= c["limit"] if c["pass"] == "<=" else
                  c["value"] >= c["limit"] for c in checks.values())
    return correct, checks
