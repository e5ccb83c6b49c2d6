"""Network analysis on the PyTorch port (paper Section 7.4): find the
cohesive core of a power-law network, compare k_max-truss vs c_max-core,
bound the maximum clique, and extract the top-2 classes with the top-down
algorithm.

Run:  PYTHONPATH=src python examples/truss_analysis_torch.py [--device cpu]

The counterpart of ``examples/truss_analysis.py`` on ``repro_torch``: the
same R-MAT graph, calls and printed lines, on the CUDA card unless
``--device`` names another torch device.
"""
import argparse

from repro_torch.core.graph import clustering_coefficient, incident_vertices
from repro_torch.core.kcore import cmax_core
from repro_torch.core.peel import kmax_truss
from repro_torch.core.sparsify import clique_upper_bound
from repro_torch.core.top_down import top_down_decompose
from repro_torch.data import graphgen


def main(device=None):
    n, edges = graphgen.rmat(scale=13, edge_factor=10, seed=7)
    print(f"R-MAT graph: n={n}, m={len(edges)}")

    kmax, truss = kmax_truss(n, edges, device=device)
    cmax, core = cmax_core(n, edges, device=device)
    vt, vc = len(incident_vertices(truss)), len(incident_vertices(core))
    print(f"k_max-truss: k={kmax}, |V|={vt}, |E|={len(truss)}, "
          f"CC={clustering_coefficient(n, truss):.2f}")
    print(f"c_max-core : c={cmax}, |V|={vc}, |E|={len(core)}, "
          f"CC={clustering_coefficient(n, core):.2f}")
    print(f"max clique is <= k_max = "
          f"{clique_upper_bound(n, edges, device=device)} "
          f"(vs the weaker c_max+1 = {cmax + 1})")

    td = top_down_decompose(n, edges, t=2, device=device)
    for k in td.classes:
        print(f"top-down Phi_{k}: {(td.phi == k).sum()} edges "
              f"(candidate subgraphs: {td.candidate_sizes[:4]}...)")


if __name__ == "__main__":
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="torch device (default: the CUDA card)")
    main(ap.parse_args().device)
