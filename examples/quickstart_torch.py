"""Quickstart on the PyTorch port: truss-decompose the paper's running
example (Figure 2).

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]

The counterpart of ``examples/quickstart.py`` on ``repro_torch``: the same
graph, calls and printed lines, on the CUDA card unless ``--device`` names
another torch device.
"""
import argparse

import numpy as np

from repro_torch.core import graph as glib
from repro_torch.core.peel import truss_decompose
from repro_torch.core.bottom_up import bottom_up_decompose
from repro_torch.core.top_down import top_down_decompose

NAMES = {c: i for i, c in enumerate("abcdefghijkl")}
EDGES = """a b;a c;a d;a e;b c;b d;b e;c d;c e;d e;d g;d k;d l;e f;e g;f g;
g h;g k;g l;f h;f i;f j;h i;h j;i j;i k"""


def main(device=None):
    edges = np.array([[NAMES[x] for x in p.split()]
                      for p in EDGES.replace("\n", "").split(";") if p.strip()])
    n = 12
    ce = glib.canonical_edges(edges, n)
    inv = {v: k for k, v in NAMES.items()}

    phi = truss_decompose(n, ce, device=device)
    print("k-classes of the Figure-2 graph:")
    for k in sorted(set(phi.tolist())):
        cls = [f"({inv[u]},{inv[v]})" for (u, v), p in zip(ce, phi) if p == k]
        print(f"  Phi_{k}: {' '.join(cls)}")
    print(f"  k_max = {phi.max()}  (the 5-truss is the clique a-e)")

    # same answer from the I/O-efficient paths with a tiny memory budget
    bu = bottom_up_decompose(n, ce, budget=10, device=device)
    td = top_down_decompose(n, ce, device=device)
    assert (bu.phi == phi).all() and (td.phi == phi).all()
    print("bottom-up (budget=10 edges) and top-down agree. "
          f"bottom-up used {bu.rounds} partition rounds, {bu.scans} scans.")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
