"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its timings; any mismatch raises and exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of every CUDA kernel under ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together);
2. every kernel against its plain PyTorch version on the card, exact
   equality, with its time, its bound and, where one PyTorch call computes
   the same function, that call's time;
3. in-memory route: ``truss_decompose`` on R-MAT scale 17;
4. bottom-up route: ``truss_decompose(engine="bottom-up", memory_budget=
   estimate_working_set // 16)`` on R-MAT scale 15;
5. top-down: ``top_down_decompose`` on R-MAT scale 15, then on a dense core
   (Erdos-Renyi, 2,048 vertices, 314,000 edges) that the density rule routes
   to the dense-support kernel;
6. phi of every graph of phases 3-5 against digests of the JAX package's
   answer, and the paper's Figure-2 graph against the port's serial oracle.

Phases 3-5 are the main path: every launch counter is set to 0 before phase
3 and read after phase 5, and each kernel of the path must have launched.
The kernels are then timed again on the largest inputs the main path gave
them.  The line before the last is a JSON object listing every kernel; the
last line is ``{"ok": true, "device": {...}}``.  Without CUDA, or without
the repository beside it, the script exits non-zero and prints no result.

``--profile`` also traces each phase of the main path with
``torch.profiler`` (CUDA activity only) and prints the device's busy time,
its idle share and the kernels that took the most device time; the walls of
that run include the tracing.
"""

from __future__ import annotations

import hashlib
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12

# phi digests of the JAX package (repro.core.peel.truss_decompose, default
# route), made on the CPU from the repository root with:
#   PYTHONPATH=src JAX_PLATFORMS=cpu python -c "
#   import hashlib, numpy as np
#   from repro.core.peel import truss_decompose
#   from repro.data.graphgen import rmat, erdos_renyi
#   for n, e in (rmat(17, 8, seed=5), rmat(15, 8, seed=5),
#                (2048, erdos_renyi(2048, 314_000, seed=5))):
#       phi = np.asarray(truss_decompose(n, e)).astype(np.int64)
#       k, c = np.unique(phi, return_counts=True)
#       print(len(e), phi.max(), dict(zip(k.tolist(), c.tolist())),
#             hashlib.sha256(phi.tobytes()).hexdigest())"
DIGESTS = {
    "rmat17": dict(
        m=971_168, triangles=8_750_686, kmax=95,
        sha256="4f3f024d81cfc3140c2fb9937275949695813105f2d37711c1f495d7d99c8295",
        classes={2: 177003, 3: 106261, 4: 76341, 5: 60431, 6: 47180,
                 7: 36748, 8: 31589, 9: 30959, 10: 32242, 11: 30899,
                 12: 26101, 13: 19492, 14: 13430, 15: 9246, 16: 6247,
                 17: 5327, 18: 6332, 19: 7898, 20: 11241, 21: 14877,
                 22: 16879, 23: 17898, 24: 17843, 25: 15928, 26: 14049,
                 27: 10611, 28: 8721, 29: 6654, 30: 4670, 31: 3338,
                 32: 2273, 33: 1474, 34: 1225, 35: 469, 36: 398, 37: 185,
                 38: 50, 39: 19, 40: 32, 41: 156, 42: 188, 43: 224, 44: 982,
                 45: 1759, 46: 2774, 47: 27271, 48: 3194, 49: 1792,
                 50: 1628, 51: 1368, 52: 1730, 53: 1212, 54: 2784, 55: 2960,
                 56: 4019, 57: 4120, 58: 4332, 59: 5076, 60: 4655,
                 61: 3613, 62: 3403, 63: 2222, 64: 1691, 65: 1556,
                 66: 1819, 67: 670, 68: 510, 69: 431, 70: 261, 74: 91,
                 92: 116, 93: 117, 94: 474, 95: 9410}),
    "rmat15": dict(
        m=234_003, triangles=1_712_253, kmax=59,
        sha256="feca9dbd34398d0b955286d34bb6cf84071fb1ad5ef365a0596806939348c478",
        classes={2: 35517, 3: 25180, 4: 19370, 5: 15527, 6: 13390,
                 7: 11877, 8: 9852, 9: 6610, 10: 5050, 11: 5001, 12: 5919,
                 13: 6714, 14: 7053, 15: 7176, 16: 5559, 17: 4378,
                 18: 3243, 19: 2262, 20: 1439, 21: 1199, 22: 654, 23: 528,
                 24: 985, 25: 1432, 26: 2689, 27: 2809, 28: 2425, 29: 1583,
                 30: 1394, 31: 1453, 32: 1768, 33: 2189, 34: 2311,
                 35: 2087, 36: 2395, 37: 2546, 38: 2180, 39: 1861, 40: 927,
                 41: 726, 42: 566, 43: 295, 44: 63, 45: 2, 47: 63, 55: 1,
                 56: 2, 57: 79, 58: 81, 59: 5593}),
    "er2048": dict(
        m=314_000, triangles=7_714_423, kmax=46,
        sha256="0bc1009d28a216e28810f6a5e7ad20af3c7988ea495fdc97aaf3982fe9f71c7e",
        classes={26: 1, 27: 2, 28: 2, 29: 7, 30: 12, 31: 15, 32: 45,
                 33: 82, 34: 293, 35: 673, 36: 1886, 37: 3391, 38: 6983,
                 39: 13089, 40: 18678, 41: 24334, 42: 32845, 43: 37083,
                 44: 34838, 45: 25301, 46: 114440}),
}

# the paper's Figure-2 graph (examples/quickstart.py) and its k-classes
FIG2 = ("ab ac ad ae bc bd be cd ce de dg dk dl ef eg fg gh gk gl fh fi fj "
        "hi hj ij ik")
FIG2_CLASSES = {2: 1, 3: 9, 4: 6, 5: 10}


def say(*parts) -> None:
    print(*parts, flush=True)


def nvidia_smi() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def time_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()`` by CUDA events, after warm-up."""
    for _ in range(2):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def b1_bound_ms(B: int, E: int, T: int) -> float:
    """Least time of one fused round: the triangle rows (12 B per row) and
    the five (B, E) int32 arrays (sup, alive, rm in; sup', alive' out), each
    moved once over the memory rate."""
    return (12 * B * T + 20 * B * E) / HBM_BYTES_PER_S * 1e3


def b2_bound(n: int) -> tuple[float, str]:
    """Least time of S = (A A) o A: 2 n^3 int8 operations against n^2 bytes
    read and 4 n^2 written; the larger bounds it."""
    ops = 2 * n ** 3 / INT8_OPS_PER_S * 1e3
    byt = 5 * n * n / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= byt else (byt, "bytes")


class Probe:
    """Wraps a kernel wrapper for the main path: brackets every call with
    CUDA events (device time), sums the bound of every call, and keeps the
    inputs of the largest call to time the kernel on afterwards."""

    def __init__(self, torch, module, name: str, size, bound):
        self.torch, self.module, self.name = torch, module, name
        self.fn = getattr(module, name)
        self.size, self.bound = size, bound
        self.events, self.bound_ms, self.largest = [], 0.0, None
        self.shapes: dict = {}
        setattr(module, name, self)

    def __call__(self, *args):
        ev = self.torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        out = self.fn(*args)
        end.record()
        self.events.append((start, end))
        self.bound_ms += self.bound(*args)
        key = tuple(tuple(a.shape) for a in args)
        self.shapes[key] = self.shapes.get(key, 0) + 1
        if self.largest is None or self.size(*args) > self.size(*self.largest):
            self.largest = args
        return out

    def close(self) -> float:
        """Restore the wrapper; return the summed device ms of all calls."""
        setattr(self.module, self.name, self.fn)
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def phi_digest(phi: np.ndarray) -> dict:
    phi = np.asarray(phi).astype(np.int64)
    k, c = np.unique(phi, return_counts=True)
    return dict(m=len(phi), kmax=int(phi.max()),
                classes=dict(zip(k.tolist(), c.tolist())),
                sha256=hashlib.sha256(phi.tobytes()).hexdigest())


def check_digest(name: str, phi: np.ndarray) -> None:
    want = {k: v for k, v in DIGESTS[name].items() if k != "triangles"}
    got = phi_digest(phi)
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise AssertionError(f"{name}: phi differs from the JAX digest: "
                             f"{str(diff)[:2000]}")


def main(argv) -> int:
    import torch
    from torch.autograd import DeviceType

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this script "
              "runs the port on an NVIDIA card", file=sys.stderr)
        return 2
    if argv not in ([], ["--profile"]):
        print("usage: python3 chip_smoke.py [--profile]", file=sys.stderr)
        return 2
    profile = bool(argv)
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch import device as rdev
    from repro_torch.core import serial
    from repro_torch.core.graph import build_graph, canonical_edges
    from repro_torch.core.peel import estimate_working_set, truss_decompose
    from repro_torch.core.bottom_up import bottom_up_decompose
    from repro_torch.core.support import edge_support
    from repro_torch.core.top_down import top_down_decompose
    from repro_torch.data.graphgen import erdos_renyi, rmat
    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_peel import kernel as fk
    from repro_torch.kernels.frontier_peel import ref as fref
    from repro_torch.kernels.triangle_count import kernel as tk
    from repro_torch.kernels.triangle_count import ref as tref

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_all = time.perf_counter()

    # -- phase 1: device and build -------------------------------------------
    smi = nvidia_smi()
    say(smi)
    say(f"[1] torch {torch.__version__} cuda {torch.version.cuda} "
        f"device {torch.cuda.get_device_name(0)} "
        f"count {torch.cuda.device_count()}")
    t0 = time.perf_counter()
    reports = build.build()
    say(f"[1] kernel build {time.perf_counter() - t0:.2f} s "
        f"({', '.join(reports) or 'cached'})")
    for name, log in reports.items():
        for line in log.splitlines():
            if "Used" in line:
                say(f"[1]   {name}: {line.strip()}")

    # -- phase 2: kernels against their plain versions -----------------------
    gen = torch.Generator(device=dev).manual_seed(0)

    def b1_inputs(B, E, T):
        sup = torch.randint(0, 64, (B, E), generator=gen, device=dev,
                            dtype=torch.int32)
        alive = (torch.rand((B, E), generator=gen, device=dev) < 0.9).int()
        rm = alive * (torch.rand((B, E), generator=gen, device=dev)
                      < 0.1).int()
        tris = torch.randint(0, E, (B, T, 3), generator=gen, device=dev,
                             dtype=torch.int32)
        tris[:, T - T // 8:] = E          # padding rows on the drop slot
        tris[:, : T // 16, 2] = E         # rows with one corner on E
        return sup, alive, rm, tris

    for B, E, T in ((1, 4096, 1 << 14), (8, 4096, 1 << 16),
                    (1, 65536, 1 << 20), (8, 65536, 1 << 20)):
        args = b1_inputs(B, E, T)
        got, want = fk.fused_round(*args), fref.fused_round(*args)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            if not torch.equal(g_, w_):
                raise AssertionError(f"B1 fused_round differs from its plain "
                                     f"version at B={B} E={E} T={T}")
        ms = time_ms(torch, lambda: fk.fused_round(*args), 20)
        plain = time_ms(torch, lambda: fref.fused_round(*args), 5)
        say(f"[2] B1 fused_round B={B} E={E} T={T}: equal; kernel "
            f"{ms:.4f} ms, plain {plain:.4f} ms, bound "
            f"{b1_bound_ms(B, E, T):.4f} ms (bytes)")
        del args, got, want

    for n in (256, 1000, 2048, 4096):
        A = (torch.rand((n, n), generator=gen, device=dev) < 0.15).to(
            torch.uint8)
        A = torch.triu(A, 1)
        A = A + A.T
        got, want = tk.triangle_count(A), tref.support_dense(A)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B2 triangle_count differs from its plain "
                                 f"version at n={n}")
        Af = A.float()
        ms = time_ms(torch, lambda: tk.triangle_count(A), 20)
        plain = time_ms(torch, lambda: tref.support_dense(A), 10)
        lib = time_ms(torch, lambda: torch.matmul(Af, Af).mul_(Af), 10)
        bound, by = b2_bound(n)
        say(f"[2] B2 triangle_count n={n}: equal; kernel {ms:.4f} ms, "
            f"plain {plain:.4f} ms, matmul+mask {lib:.4f} ms, bound "
            f"{bound:.4f} ms ({by})")
        del A, Af, got, want

    # -- main path: phases 3-5 -----------------------------------------------
    fk.LAUNCHES = tk.LAUNCHES = 0
    p1 = Probe(torch, fk, "fused_round",
               size=lambda s, a, r, t: s.numel() + t.numel(),
               bound=lambda s, a, r, t: b1_bound_ms(s.shape[0], s.shape[1],
                                                    t.shape[1]))
    p2 = Probe(torch, tk, "triangle_count", size=lambda A: A.numel(),
               bound=lambda A: b2_bound(A.shape[0])[0])
    phase_launches = {}

    def run_phase(tag, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        l0, s0 = (fk.LAUNCHES, tk.LAUNCHES), rdev.SYNCS
        prof = None
        if profile:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = (fk.LAUNCHES - l0[0], tk.LAUNCHES - l0[1])
        phase_launches[tag] = launches
        say(f"[{tag}] wall {wall:.3f} s, host syncs {rdev.SYNCS - s0}, "
            f"launches B1 {launches[0]} B2 {launches[1]}, peak device "
            f"memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
        if prof is not None:
            prof.__exit__(None, None, None)
            # device-side events (kernels, copies, memsets) of the phase,
            # read raw: key_averages() takes minutes on a trace this long
            per_name: dict = {}
            for e in prof.profiler.kineto_results.events():
                if e.device_type() == DeviceType.CUDA:
                    ns, cnt = per_name.get(e.name(), (0, 0))
                    per_name[e.name()] = (ns + e.duration_ns(), cnt + 1)
            busy = sum(ns for ns, _ in per_name.values()) / 1e9
            if busy == 0:
                say(f"[{tag}] profiled: device busy time not measured (the "
                    f"trace holds no device events)")
            else:
                say(f"[{tag}] profiled: device busy {busy:.3f} s of "
                    f"{wall:.3f} s wall (idle share {1 - busy / wall:.4f})")
            for name, (ns, cnt) in sorted(per_name.items(),
                                          key=lambda kv: -kv[1][0])[:6]:
                say(f"[{tag}]   {ns / 1e6:10.1f} ms {cnt:7d}x {name[:90]}")
        return out

    def graph(name, n, edges):
        d = DIGESTS[name]
        g = build_graph(n, edges)
        tri = int(edge_support(g, device=dev).sum()) // 3
        if (g.m, tri) != (d["m"], d["triangles"]):
            raise AssertionError(f"{name}: m={g.m} T={tri}, expected "
                                 f"m={d['m']} T={d['triangles']}")
        say(f"[{name}] n={n} m={g.m} T={tri}")
        return g

    # phase 3: in-memory route
    n17, e17 = rmat(17, 8, seed=5)
    graph("rmat17", n17, e17)
    phi17, pst = run_phase("3 in-memory rmat17", lambda: truss_decompose(
        n17, e17, with_stats=True, device=dev))
    say(f"[3] PeelStats {pst}")

    # phase 4: bottom-up route
    n15, e15 = rmat(15, 8, seed=5)
    g15 = graph("rmat15", n15, e15)
    phi15 = run_phase("4a in-memory rmat15",
                      lambda: truss_decompose(n15, e15, device=dev))
    budget = estimate_working_set(g15) // 16
    phi15_bu, ost = run_phase("4 bottom-up rmat15", lambda: truss_decompose(
        n15, e15, engine="bottom-up", memory_budget=budget, with_stats=True,
        device=dev))
    say(f"[4] memory_budget {budget} entries; OocStats {ost}")
    say(f"[4] host candidate building {ost.candidate_build_s:.3f} s, "
        f"stage-1 batch building {ost.round_build_s:.3f} s, device peels "
        f"{ost.peel_s:.3f} s")
    if not np.array_equal(phi15_bu, phi15):
        raise AssertionError("bottom-up phi differs from the in-memory route")
    if phase_launches["4 bottom-up rmat15"][0] == 0:
        raise AssertionError("bottom-up never launched the B1 kernel")

    # phase 5: top-down, sparse then a dense core
    td15 = run_phase("5a top-down rmat15",
                     lambda: top_down_decompose(n15, e15, device=dev))
    say(f"[5a] classes {len(td15.classes)}, kmax {td15.kmax}, "
        f"levels {td15.stats.scans}, pruned {td15.pruned}, host "
        f"candidate building {td15.stats.candidate_build_s:.3f} s, device "
        f"peels {td15.stats.peel_s:.3f} s")
    if not np.array_equal(td15.phi, phi15):
        raise AssertionError("top-down phi differs on rmat15")
    e_er = erdos_renyi(2048, 314_000, seed=5)
    graph("er2048", 2048, e_er)
    phi_er = run_phase("5b in-memory er2048",
                       lambda: truss_decompose(2048, e_er, device=dev))
    td_er = run_phase("5c top-down er2048",
                      lambda: top_down_decompose(2048, e_er, device=dev))
    say(f"[5c] classes {len(td_er.classes)}, kmax {td_er.kmax}, "
        f"levels {td_er.stats.scans}, pruned {td_er.pruned}, host "
        f"candidate building {td_er.stats.candidate_build_s:.3f} s, device "
        f"peels {td_er.stats.peel_s:.3f} s")
    if not np.array_equal(td_er.phi, phi_er):
        raise AssertionError("top-down phi differs on er2048")
    if phase_launches["5c top-down er2048"][1] == 0:
        raise AssertionError("top-down never launched the B2 kernel on the "
                             "dense core")
    launches = {"frontier_peel": fk.LAUNCHES, "triangle_count": tk.LAUNCHES}
    total_ms = {"frontier_peel": p1.close(), "triangle_count": p2.close()}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the main "
                                 f"path")
    if (len(p1.events), len(p2.events)) != tuple(launches.values()):
        raise AssertionError("launch counters disagree with the calls seen")
    say(f"[main path] launches {launches}, device ms in kernel calls "
        f"{ {k: round(v, 3) for k, v in total_ms.items()} }, summed bounds "
        f"B1 {p1.bound_ms:.3f} ms B2 {p2.bound_ms:.3f} ms")
    say(f"[main path] B1 launch shapes (count): "
        f"{sorted(p1.shapes.items(), key=lambda kv: -kv[1])[:8]}")

    # -- phase 6: digests -----------------------------------------------------
    for name, phi in (("rmat17", phi17), ("rmat15", phi15),
                      ("rmat15", phi15_bu), ("rmat15", td15.phi),
                      ("er2048", phi_er), ("er2048", td_er.phi)):
        check_digest(name, phi)
    names = {c: i for i, c in enumerate("abcdefghijkl")}
    fig2 = canonical_edges(np.array([[names[p[0]], names[p[1]]]
                                     for p in FIG2.split()]), 12)
    want = serial.alg2_truss(12, fig2)
    k, c = np.unique(want, return_counts=True)
    assert dict(zip(k.tolist(), c.tolist())) == FIG2_CLASSES, (k, c)
    for got in (truss_decompose(12, fig2, device=dev),
                bottom_up_decompose(12, fig2, 10, device=dev).phi,
                top_down_decompose(12, fig2, device=dev).phi):
        if not np.array_equal(got, want):
            raise AssertionError("Figure-2 graph: phi differs from alg2_truss")
    say("[6] phi equals the JAX digests on rmat17, rmat15 (in-memory, "
        "bottom-up, top-down) and er2048 (in-memory, top-down); Figure-2 "
        "equals alg2_truss")

    # -- kernels on the largest inputs the main path gave them ---------------
    kernels = []
    args = p1.largest
    got, want = fk.fused_round(*args), fref.fused_round(*args)
    err = max(int((g_ - w_).abs().max()) for g_, w_ in zip(got, want))
    B, E, T = args[0].shape[0], args[0].shape[1], args[3].shape[1]
    kernels.append(dict(
        name="frontier_peel.fused_round", route="cuda",
        source="src/repro_torch/csrc/frontier_peel.cu",
        replaces="src/repro/kernels/frontier_peel/kernel.py:115",
        launches=launches["frontier_peel"], max_abs_err=float(err),
        ms=time_ms(torch, lambda: fk.fused_round(*args), 20),
        plain_ms=time_ms(torch, lambda: fref.fused_round(*args), 5),
        bound_ms=b1_bound_ms(B, E, T), bound_by="bytes", library_ms=None,
        shape=[B, E, T], total_ms=total_ms["frontier_peel"],
        total_bound_ms=p1.bound_ms))
    (A,) = p2.largest
    got, want = tk.triangle_count(A), tref.support_dense(A)
    Af = A.float()
    bound, by = b2_bound(A.shape[0])
    kernels.append(dict(
        name="triangle_count.triangle_count", route="cuda",
        source="src/repro_torch/csrc/triangle_count.cu",
        replaces="src/repro/kernels/triangle_count/kernel.py:73",
        launches=launches["triangle_count"],
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(torch, lambda: tk.triangle_count(A), 20),
        plain_ms=time_ms(torch, lambda: tref.support_dense(A), 10),
        bound_ms=bound, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.matmul(Af, Af).mul_(Af), 10),
        shape=[A.shape[0]], total_ms=total_ms["triangle_count"],
        total_bound_ms=p2.bound_ms))
    for kern in kernels:
        if kern["max_abs_err"] != 0:
            raise AssertionError(f"{kern['name']} differs from its plain "
                                 f"version on the main path's inputs")
    say(f"[all] wall {time.perf_counter() - t_all:.1f} s; {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
