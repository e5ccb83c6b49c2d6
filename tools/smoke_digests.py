"""Reference numbers of ``chip_smoke.py``'s phases 8a-8e, made with the JAX
package (``src/repro``) on the CPU.

Run from the repository root (a few minutes, about 2 GB of host memory):

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/smoke_digests.py

It prints the ``DIGESTS["rmat13"]`` entry and the ``MAINT_DIGESTS`` dict
that ``chip_smoke.py`` holds the port's results against:

* ``rmat13``: phi of R-MAT scale 13, seed 5 (``truss_decompose``);
* ``8a``: phi after ``truss_maintain`` of ``chip_smoke.edit_batch``'s 1 and
  64 edits, and of ``chip_smoke.closing_insert``'s one insertion that
  closes triangles, on R-MAT scale 15, seed 5, from its in-memory phi;
* ``8b``: the same with 16 edits on R-MAT scale 13 through a
  ``ChunkedDiskStore`` in ``chip_smoke.store_budget``'s regime, journaled
  every edit: phi and the store's write counters;
* ``8c``: Table 6 on R-MAT scale 17 (``benchmarks/run.py``'s
  ``table6_truss_vs_core``): the core numbers (``core_decompose``), the
  c_max-core and the k_max-truss, and both clustering coefficients.  The
  k_max-truss is the one subgraph whose every edge has at least k_max - 2
  triangles in it, found by pruning with the host support (k_max from
  ``DIGESTS["rmat17"]``), so rmat17 is never peeled here;
* ``8e``: ``bottom_up_decompose(engine="perpart")`` on R-MAT scale 13 at the
  partition budget ``truss_decompose`` derives from
  ``estimate_working_set // 16``: its rounds and scans.
"""

from __future__ import annotations

import hashlib
import json
import sys
import tempfile
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

from chip_smoke import (DIGESTS, closing_insert, edit_batch,  # noqa: E402
                        phi_digest, store_budget)
from repro.core.bottom_up import bottom_up_decompose  # noqa: E402
from repro.core.graph import (build_graph, clustering_coefficient,  # noqa: E402
                              incident_vertices)
from repro.core.kcore import cmax_core, core_decompose  # noqa: E402
from repro.core.maintain import truss_maintain  # noqa: E402
from repro.core.peel import estimate_working_set, truss_decompose  # noqa: E402
from repro.core.store import ChunkedDiskStore  # noqa: E402
from repro.core.support import edge_support_np  # noqa: E402
from repro.data.graphgen import rmat  # noqa: E402


def sha(a: np.ndarray) -> str:
    return hashlib.sha256(np.asarray(a).astype(np.int64).tobytes()).hexdigest()


def maint_row(res) -> dict:
    st = res.stats
    return dict(m=res.graph.m, sha256=sha(res.phi),
                edits_applied=st.edits_applied,
                maintain_levels=st.maintain_levels,
                affected_edges=st.affected_edges)


def ktruss(n: int, edges: np.ndarray, k: int) -> np.ndarray:
    """Edges of the k-truss: prune edges with fewer than k - 2 triangles
    among the kept edges until none is left to prune."""
    keep = edges
    while True:
        sup = edge_support_np(build_graph(n, keep), chunk=1 << 12)
        ok = sup >= k - 2
        if ok.all():
            return keep
        keep = keep[ok]


def main() -> None:
    out: dict = {}
    n13, e13 = rmat(13, 8, seed=5)
    g13 = build_graph(n13, e13)
    phi13 = np.asarray(truss_decompose(n13, e13)).astype(np.int64)
    rmat13 = phi_digest(phi13)
    rmat13["triangles"] = int(edge_support_np(g13).sum()) // 3
    print("rmat13", json.dumps(rmat13), flush=True)

    # 8e: the per-part bottom-up at truss_decompose's partition budget
    est = estimate_working_set(g13)
    part_budget = max(64, (2 * g13.m * (est // 16)) // max(est, 1))
    res = bottom_up_decompose(n13, e13, part_budget, engine="perpart")
    assert (np.asarray(res.phi) == phi13).all()
    out["8e"] = dict(part_budget=part_budget, rounds=res.rounds,
                     scans=res.scans)
    print("8e", out["8e"], flush=True)

    # 8b: 16 edits through a disk store, journaled every edit
    _, host_budget, chunk_bytes = store_budget(g13)
    with tempfile.TemporaryDirectory() as top:
        with ChunkedDiskStore(top + "/store", host_memory_budget=host_budget,
                              chunk_bytes=chunk_bytes) as store:
            res = truss_maintain((n13, e13), phi13, edit_batch(n13, e13, 16),
                                 store=store, checkpoint_dir=top + "/j",
                                 checkpoint_every=1)
    out["8b"] = dict(maint_row(res), chunk_writes=res.stats.chunk_writes,
                     bytes_spilled=res.stats.bytes_spilled)
    print("8b", out["8b"], flush=True)

    # 8a: 1 and 64 edits on rmat15 from its in-memory phi
    n15, e15 = rmat(15, 8, seed=5)
    phi15 = np.asarray(truss_decompose(n15, e15)).astype(np.int64)
    assert sha(phi15) == DIGESTS["rmat15"]["sha256"]
    for key, steps in (("b1", edit_batch(n15, e15, 1)),
                       ("b64", edit_batch(n15, e15, 64)),
                       ("b1_closing", closing_insert(n15, e15))):
        res = truss_maintain((n15, e15), phi15, steps)
        out[f"8a_{key}"] = maint_row(res)
        print(f"8a {key}", out[f"8a_{key}"], flush=True)

    # 8c: Table 6 on rmat17
    n17, e17 = rmat(17, 8, seed=5)
    core = core_decompose(n17, e17)
    cmax, c_edges = cmax_core(n17, e17)
    kmax = DIGESTS["rmat17"]["kmax"]
    t_edges = ktruss(n17, e17, kmax)
    assert len(t_edges) == DIGESTS["rmat17"]["classes"][kmax]
    out["8c"] = dict(core_sha256=sha(core), cmax=cmax, kmax=kmax,
                     vt=len(incident_vertices(t_edges)),
                     vc=len(incident_vertices(c_edges)),
                     et=len(t_edges), ec=len(c_edges),
                     cct=clustering_coefficient(n17, t_edges),
                     ccc=clustering_coefficient(n17, c_edges))
    print("8c", out["8c"], flush=True)
    print("MAINT_DIGESTS =", repr(out))


if __name__ == "__main__":
    main()
