"""Host profile of ``chip_smoke.py``'s phase 8a at b = 64 on the card.

Run from the repository root on a machine with one NVIDIA card:

    python3 tools/profile_maintain.py [OUT_DIR]

It repeats phase 8a's b = 64 call (``truss_maintain`` of
``chip_smoke.edit_batch``'s 64 edits on R-MAT scale 15, seed 5, from the
graph's in-memory phi), once plain and once under ``cProfile``, checks phi
against the JAX package's (``chip_smoke.MAINT_DIGESTS``), and prints
the card's name and power limit, both walls, the cumulative seconds of the
maintenance's steps (region growth, its triangle-partner intersections,
the region peels and the triangle sort before each upload, the id splices)
and the functions that take the most time of their own.  The full profile
goes to ``OUT_DIR/profile_maintain.txt`` (default ``build/profile``).
"""

from __future__ import annotations

import cProfile
import io
import json
import pstats
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

# (label, module file suffix, function name): the maintenance's steps
STEPS = (
    ("truss_maintain", "core/maintain.py", "truss_maintain"),
    ("_grow_region", "core/maintain.py", "_grow_region"),
    ("_tri_partners", "core/maintain.py", "_tri_partners"),
    ("_peel_region", "core/maintain.py", "_peel_region"),
    ("local_threshold_peel", "core/peel.py", "local_threshold_peel"),
    ("host_read", "repro_torch/device.py", "host_read"),
    ("_apply_delete", "core/maintain.py", "_apply_delete"),
    ("_apply_insert", "core/maintain.py", "_apply_insert"),
    ("Graph.add_edges", "core/graph.py", "add_edges"),
    ("Graph.remove_edges", "core/graph.py", "remove_edges"),
    ("_Adjacency.plus", "core/maintain.py", "plus"),
    ("_Adjacency.without", "core/maintain.py", "without"),
)


def _where(key) -> str:
    file, line, name = key
    return f"{name} ({Path(file).name}:{line})" if line else name


def main(argv) -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_maintain: torch.cuda.is_available() is false; this "
              "script profiles the port on an NVIDIA card", file=sys.stderr)
        return 2
    out_dir = Path(argv[0]) if argv else ROOT / "build" / "profile"
    out_dir.mkdir(parents=True, exist_ok=True)
    import chip_smoke
    from repro_torch.core.maintain import truss_maintain
    from repro_torch.core.peel import truss_decompose
    from repro_torch.data.graphgen import rmat
    from repro_torch.kernels import build

    print(f"card: {chip_smoke.nvidia_smi()}")
    build.build(["frontier_peel"])
    n, edges = rmat(15, 8, seed=5)
    phi0 = truss_decompose(n, edges, device="cuda")
    steps = chip_smoke.edit_batch(n, edges, 64)

    def run():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        res = truss_maintain((n, edges), phi0, steps, device="cuda")
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    res, plain_s = run()
    prof = cProfile.Profile()
    prof.enable()
    res_p, prof_s = run()
    prof.disable()
    if not np.array_equal(res.phi, res_p.phi):
        raise AssertionError("the profiled run's phi differs from the plain "
                             "run's")
    chip_smoke.check_maint("8a b=64", res, chip_smoke.MAINT_DIGESTS["8a_b64"])
    stats = pstats.Stats(prof)
    cum = {}
    for label, suffix, name in STEPS:
        cum[label] = sum(
            v[3] for (f, _, fn), v in stats.stats.items()
            if fn == name and f.replace("\\", "/").endswith(suffix))
    # np.intersect1d and the triangle sort, split by the step that calls them
    by_caller = {}
    for (f, line, fn), v in stats.stats.items():
        if fn in ("intersect1d", "<built-in method builtins.sorted>"):
            for caller, cv in v[4].items():
                key = f"{fn.split('.')[-1].rstrip('>')} in {caller[2]}"
                by_caller[key] = by_caller.get(key, 0.0) + cv[3]
    own = sorted(stats.stats.items(), key=lambda kv: -kv[1][2])[:12]
    summary = dict(
        b=64, m=res.graph.m, edits_applied=res.stats.edits_applied,
        maintain_levels=res.stats.maintain_levels,
        affected_edges=res.stats.affected_edges,
        wall_plain_s=plain_s, wall_profiled_s=prof_s,
        cumulative_s=cum, by_caller_s=by_caller,
        own_time_s=[[_where(k), v[1], v[2]] for k, v in own])
    text = io.StringIO()
    pstats.Stats(prof, stream=text).sort_stats("cumulative").print_stats(60)
    (out_dir / "profile_maintain.txt").write_text(text.getvalue())
    print(json.dumps(summary))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
