"""The paper's technique as a pipeline feature, on the PyTorch port: train
GraphSAGE with truss-based neighbour sampling (strong-tie-weighted fanouts)
and compare against uniform sampling.

Run:  PYTHONPATH=src python examples/train_gnn_truss_torch.py [--device cpu]

The counterpart of ``examples/train_gnn_truss.py``: the same graph, labels,
features, sampler, sizes, optimizer settings and printed line, with torch
autograd and the port's ``optim.adamw`` on the CUDA card unless
``--device`` names another torch device.  The parameters come from a torch
generator seeded with 0, which cannot reproduce ``jax.random.PRNGKey(0)``'s
draw, so the losses are not the reference's: they are held to be finite
and to fall.
"""
import argparse

import numpy as np
import torch

from repro_torch.configs.cells import value_and_grad
from repro_torch.core.sparsify import sampling_weights, trussness_features
from repro_torch.data import graphgen
from repro_torch.device import resolve_device
from repro_torch.models.gnn import models as G
from repro_torch.models.gnn.sampler import CSR, minibatch
from repro_torch.optim import adamw


def train(weighted: bool, steps: int = 60, device=None) -> list:
    """The loss of every step (before its update), as floats."""
    dev = resolve_device(device)
    n = 400
    edges = graphgen.planted_cliques(n, 8, 8, 900, seed=1)
    rng = np.random.default_rng(0)
    # labels correlate with membership in cohesive cores -> trussness-aware
    # sampling should help
    _, tf = trussness_features(n, edges, device=dev)
    node_core = np.zeros(n)
    for (u, v), t in zip(edges, tf):
        node_core[u] = max(node_core[u], t)
        node_core[v] = max(node_core[v], t)
    labels = (node_core > 0.5).astype(np.int32)
    feats = rng.standard_normal((n, 8)).astype(np.float32)
    feats[:, 0] += labels * 0.5

    w = sampling_weights(n, edges, device=dev) if weighted else None
    csr = CSR.from_edges(n, edges, edge_w=w)
    cfg = G.GraphSAGEConfig(n_layers=2, d_hidden=32, d_in=8, n_classes=2)
    params = G.sage_init(torch.Generator(device=dev).manual_seed(0), cfg)
    ocfg = adamw.AdamWConfig(lr=3e-3, warmup_steps=5, total_steps=steps)
    state = adamw.init_state(params)

    def step(params, state, batch):
        loss, g = value_and_grad(
            lambda p, b: G.sage_loss(p, b, cfg), params, batch)
        params, state, _ = adamw.update(ocfg, params, state, g)
        return params, state, loss

    losses = []
    for s in range(steps):
        mb = minibatch(csr, feats, labels, 16, (5, 3), rng)
        params, state, loss = step(params, state, {
            k: torch.as_tensor(v, device=dev) for k, v in mb.items()})
        losses.append(loss)
    # one device-to-host copy at the end, none per step
    return torch.stack(losses).tolist()


def run(weighted: bool, steps: int = 60, device=None) -> float:
    """The last step's loss."""
    return train(weighted, steps, device)[-1]


def main(device=None):
    lu = run(weighted=False, device=device)
    lw = run(weighted=True, device=device)
    print(f"GraphSAGE final loss — uniform sampling: {lu:.4f}, "
          f"truss-weighted sampling: {lw:.4f}")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
