"""Random weights of a cell, made on the device from the seed.

The benchmark makes the weights, in the layout the program's parameter
tree has (``{"embed", "final_norm", "layers": {name: (L, ...)},
"lm_head"}``), and hands the same tensors to the program and to the
reference.  Each leaf is one call on a generator on the device, all layers
at once, drawn in the type it is served in: normal, times 1 / sqrt(fan-in)
for a matrix (fan-in: its second-last dim), 0.02 for the embedding; norms
start at zero (the program scales by ``1 + w``); the router is float32.
"""

from __future__ import annotations

import math

import torch


def leaf_shapes(c: dict) -> dict:
    """{name: (shape, fan-in or None for a zero leaf)} of the stacked layer
    leaves, for the ``port`` group ``c``."""
    L, d, dh = c["n_layers"], c["d_model"], c["d_head"]
    q, kv = c["n_q"] * dh, c["n_kv"] * dh
    out = {"ln1": ((L, d), None), "ln2": ((L, d), None),
           "wq": ((L, d, q), d), "wk": ((L, d, kv), d),
           "wv": ((L, d, kv), d), "wo": ((L, q, d), q)}
    if c.get("qkv_bias"):
        out |= {"bq": ((L, q), None), "bk": ((L, kv), None),
                "bv": ((L, kv), None)}
    if c["n_experts"]:
        e, fe = c["n_experts"], c["d_ff_expert"]
        out |= {"router": ((L, d, e), d), "we_gate": ((L, e, d, fe), d),
                "we_up": ((L, e, d, fe), d), "we_down": ((L, e, fe, d), fe)}
        if c["n_shared_experts"]:
            fs = fe * c["n_shared_experts"]
            out |= {"ws_gate": ((L, d, fs), d), "ws_up": ((L, d, fs), d),
                    "ws_down": ((L, fs, d), fs)}
    else:
        f = c["d_ff"]
        out |= {"w_gate": ((L, d, f), d), "w_up": ((L, d, f), d),
                "w_down": ((L, f, d), f)}
    return out


def make_params(c: dict, seed: int, device) -> dict:
    """The parameter tree of the ``port`` group ``c`` drawn from ``seed``
    on ``device``."""
    dtype = getattr(torch, c["dtype"])
    gen = torch.Generator(device=device).manual_seed(seed)

    def normal(shape, scale, dt=dtype):
        x = torch.randn(shape, generator=gen, dtype=dt, device=device)
        return x.mul_(scale)

    layers = {}
    for name, (shape, fan_in) in leaf_shapes(c).items():
        if fan_in is None:
            layers[name] = torch.zeros(shape, dtype=dtype, device=device)
        else:
            dt = torch.float32 if name == "router" else dtype
            layers[name] = normal(shape, 1.0 / math.sqrt(fan_in), dt)
    d, v = c["d_model"], c["vocab"]
    params = {"embed": normal((v, d), 0.02),
              "final_norm": torch.zeros((d,), dtype=dtype, device=device),
              "layers": layers}
    if not c["tie_embed"]:
        params["lm_head"] = normal((d, v), 1.0 / math.sqrt(d))
    return params
