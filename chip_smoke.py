"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its timings; any mismatch raises and exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of every CUDA kernel under ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together); for every B3 instantiation, its
   registers, spills and shared memory (ptxas) and its tensor-core
   instructions (``cuobjdump -sass``): the bf16 D = 256 one must have some
   and spill nothing; the same for B1 and B2, whose SASS must hold int8 MMA
   instructions (B2) and neither of which may spill; and the registers,
   spills and static shared memory of every B4 instantiation and of its
   gather probe, none of which may spill;
2. every kernel against its plain PyTorch version on the card (B1, B2
   exact; B1's live-row round also with fewer rows than its buffer, its
   compacted rows compared as a multiset per lane, at shapes that reach
   its global-state branch and its several-lanes-a-block branch; B2 on
   symmetric and non-symmetric matrices, timed also with the A^T copy of
   ``symmetric=False``; B3, B4 within the tolerances stated at
   ``B3_F32_TOL``, ``B3_TOL``, ``B4_TOL``, ``B4_BF16_TOL``), with its time,
   its bound and, where one PyTorch call computes the same function, that
   call's time: B3 flash attention
   on the small float32 and bf16 cases of ``B3_CASES`` (every head width it
   instantiates, ragged lengths, narrow windows, non-causal), then timed at
   gemma3-4b's head shapes (causal and window 1024, bf16) beside its time
   before the tensor-core design (run E, ``B3_RUN_E_MS``); B4 embedding bag
   at every branch of its row layout (``B4_CASES``), then at DIN's table
   and batch shapes in float32 and bf16, beside its time before the warp-
   per-bag design (run H, ``B4_RUN_H_MS``), and the floor of the gather (a probe that reads the same rows and
   indices without bags) with the bytes that 32-byte sectors and 64-byte
   segments would move;
3. in-memory route: ``truss_decompose`` on R-MAT scale 17;
4. bottom-up route: ``truss_decompose(engine="bottom-up", memory_budget=
   estimate_working_set // 16)`` on R-MAT scale 15; then the same call
   4b. with ``partitioner="locality"``: its rounds and triangle capture
       beside phase 4's, phi equal, B1 launched;
   4c. with ``store=`` a ``ChunkedDiskStore`` in a temporary directory, in
       the reference benchmark's disk regime (``store_budget``: a host
       budget of an eighth of the graph's bytes, chunks of a sixteenth of
       that): phi equal, bytes spilled and chunks read, the store's peak
       resident bytes within the budget, a prefetch hit rate of at least
       0.5, B1 launched; its I/O counters and its wall beside phase 4's;
5. top-down: ``top_down_decompose`` on R-MAT scale 15, then on a dense core
   (Erdos-Renyi, 2,048 vertices, 314,000 edges) that the density rule routes
   to the dense-support kernel; then (5d) budgeted top-down,
   ``truss_decompose(engine="top-down", memory_budget=...)`` on R-MAT scale
   15 at phase 4's budget: stage 1 by ``partitioned_support`` on the host,
   the levels through B1; its phi must equal the in-memory one, with no
   retry.  After the truss path's counts are read:
   5e. kill and resume: a child process (``sys.executable``, importing only
       ``repro_torch``) runs 5d's call with a journal in a temporary
       directory (``checkpoint_every=1``) and a ``kill`` fault rule at the
       dispatch of the level halfway down 5d's classes; it must end by
       SIGKILL.  This process then resumes the same call from the journal:
       the phi must equal 5d's, ``resumed_round`` must be the journal's
       last level, ``checkpoints`` positive;
   5f. the retry ladder on R-MAT scale 13, seed 5: an allocation past the
       card's memory must raise a ``torch.OutOfMemoryError`` that
       ``faults.is_retryable`` accepts, and a B1 launch after it must equal
       its plain version; then budgeted bottom-up and top-down run under
       injected OOMs (``RETRY_PLANS``: a stage-1 dispatch twice, so two lane
       splits; a stage-2 finalize; a top-down level; the ``support`` site)
       and must give the in-memory phi with the planned retries.  That
       provoked OOM is the only error the smoke catches;
   5g. budgeted top-down with the locality partitioner through a disk
       store (``store_budget``'s regime) on 5f's graph: phi equal to its
       in-memory phi, ``partitioned_support`` wrote and read chunks;
   5h. a kill in the middle of a spill: an uninterrupted journaled
       bottom-up run through a disk store on 5f's graph counts its chunk
       writes; a child process (importing only ``repro_torch``) runs the
       same call and is SIGKILLed by a ``kill`` rule at the ``chunk-write``
       site at half that count, leaving its chunk files; the smoke resumes
       the call with a new store on the same directory, which must sweep
       the dead run's files; the resumed phi must equal the in-memory one,
       ``resumed_round`` at least 0;
8. after 5h: maintenance and the last ported modules, each through
   ``run_phase``, held to the JAX package's answers for the same calls
   (``MAINT_DIGESTS``, made by ``tools/smoke_digests.py``):
   8a. an edit stream on phase 4's graph from phase 4a's phi:
       ``truss_maintain`` of ``edit_batch``'s 1 and 64 edits (the draw of
       ``benchmarks/run.py``'s ``table5maint``), each followed by a
       recompute of the maintained edges on the card; phi equal to the
       recompute and to the digest, B1 launched at b = 64, and
       ``speedup_vs_recompute`` at least 5 at b = 1 (the reference's gate);
       B1 is then checked and timed on the largest call the maintenance
       gave it;
   8b. 16 edits on 5f's graph through a disk store in 5h's regime,
       journaled every edit: phi and the write counters equal the JAX
       package's; a child process (importing only ``repro_torch``) running
       the same call is SIGKILLed before edit 8 and resumed here on the
       same journal: the same phi, ``resumed_round`` 7, edits 8-15 alone
       replayed;
   8c. Table 6 on phase 3's graph: core numbers and the c_max-core on the
       card, the k_max-truss from phase 3's phi, and V, E, k and the
       clustering coefficients of both, equal to the JAX package's;
   8d. the global-iterate peel (``peel_recompute``) on phase 4's triangle
       list: phi equal to phase 4a's;
   8e. the per-part seed baseline, ``bottom_up_decompose(engine=
       "perpart")``, on 5f's graph: phi equal to the rmat13 digest, rounds
       and scans equal to the JAX package's;
6. phi of every graph of phases 3-5 (4b, 4c and 5d included) against
   digests of the JAX package's answer, and the paper's Figure-2 graph
   against the port's serial oracle;
7. LM serving: gemma3-4b at full width (34 layers, d_model 2560, vocab
   262,144, bf16, random weights from a generator seeded with 0, the flash
   kernel on) serves 8 requests of 2,048-token prompts and 32 greedy decode
   steps through ``serve.generate``; B3 must launch once per layer, the
   logits must be finite, and the prefill's last-token logits must agree
   with the plain attention path's within ``LOGITS_TOL``.  It also prints
   how far the plain path's logits move with a window off by one key and
   with no window at all, as a measure of what that limit can see.

Three main paths: the truss path (phases 3-5d), the maintenance path (8a)
and the LM path (phase 7); 5e-5h and 8b-8e read their own launches, each
through ``run_phase``.
Every launch counter is set to 0 just before each and read just after it,
and each kernel of the path must have launched (B1 and B2 on the truss
path, B1 on the maintenance path, B3 on the LM path; no model path reaches
B4).  The kernels are then
checked and timed again on the largest inputs their path gave them (B3:
the largest of its global and of its windowed calls).  The line before
the last is a JSON object listing every kernel; the last line is
``{"ok": true, "device": {...}}``.  Without CUDA, or without the repository
beside it, the script exits non-zero and prints no result.

``--profile`` also traces each phase of the main path with
``torch.profiler`` (CUDA activity only) and prints the device's busy time,
its idle share and the kernels that took the most device time, and B1's and
B2's own kernel time over the truss path from the trace (the plain run's
sums of ``Probe`` events include host gaps); the walls of that run include
the tracing.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
import re
import shutil
import signal
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit)
HBM_BYTES_PER_S = 3.35e12
INT8_OPS_PER_S = 1979e12
BF16_FLOPS = 989e12

# B3 against its plain version in float32: the two sum the same terms in
# other orders (as the CPU tests hold the plain version to the JAX kernel).
B3_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# B3 in bf16: the plain version computes in float32 and rounds the result to
# bf16 once.  The kernel multiplies V by P split into two bf16 terms (P_hi +
# P_lo carry about 16 bits of p, an error near 2^-17 |p|), accumulates in
# float32 and rounds once, so the two differ where their float32 values
# straddle a rounding point: one bf16 step, at most 2^-7 |o| (|o| reaches
# max |v|, about 4-5 for N(0, 1) values: a step of 2^-6 there); atol covers
# outputs near 0.  P rounded once to bf16 (an error of up to 2^-8 |p|) took
# a CPU model of the kernel past this limit on a case of B3_CASES, where the
# split stays inside it (tests/test_torch_flash_attention.py).
B3_TOL = dict(rtol=2 ** -7, atol=2e-3)
# B3 float32 cases (B, Hq, Hkv, S, D, window, causal): every accumulator
# width (D / 16 up to 1, 2, 4, 8, 16 groups, some partly used), sequence
# lengths that are not a multiple of the 64-row tiles, windows of 20, 96 and
# 1024 keys, and the non-causal branch; also run in bf16 at B3_TOL.
B3_CASES = ((2, 4, 2, 200, 64, None, True), (1, 8, 8, 130, 128, None, True),
            (2, 4, 1, 250, 64, 96, True), (1, 2, 2, 500, 32, 20, True),
            (1, 4, 2, 300, 48, 20, True), (1, 4, 2, 190, 80, 96, True),
            (1, 8, 4, 1100, 256, 1024, True), (1, 8, 4, 333, 192, 20, True),
            (1, 4, 2, 190, 16, 40, False), (1, 4, 4, 150, 128, None, False))
# B3 at gemma3-4b's head shapes before the tensor-core design, (B, window):
# ms on an H100 80GB HBM3 at 700 W (PERF.md, run E), printed beside the new
B3_RUN_E_MS = {(1, None): 1.3122, (1, 1024): 0.8989, (8, None): 7.2924,
               (8, 1024): 5.4161}
B1_DESIGN = ("one cooperative launch a round over each lane's live rows: "
             "elementwise sup'/alive' and the state packed as two bit "
             "planes, a grid barrier, then the lane's state in shared "
             "memory, 4 rows a thread and 4,096 a block, one atomicAdd a "
             "block for the compacted rows' offsets, atomicSub grouped by "
             "__match_any_sync")
B2_DESIGN = ("int8 tensor cores: wgmma m64n128k32 u8 x u8 -> s32, 128 x 128 "
             "output tiles in two warpgroups, 128-byte k-slabs in a three-"
             "stage cp.async ring under the 128-byte swizzle, B operand from "
             "the rows of A^T (A's own rows when symmetric), mask epilogue")
# the B1 and B2 kernels' names in a profiler trace
B1_TRACE_NAME = "frontier_peel_live_round"
B2_TRACE_NAME = "triangle_count_kernel"
B3_DESIGN = ("bf16: tensor cores, wgmma m64n64k16 (S = Q K^T, both from "
             "shared memory) and m64nDk16 (O += P V, P split into bf16 P_hi + "
             "P_lo in registers), 128 query rows a block in two warpgroups, "
             "64-key K/V tiles in a two-stage cp.async ring, 128-byte "
             "swizzle; float32: CUDA-core FMAs")
# B4 in float32: sums of L = 100 rows of N(0, 1) values in other orders.
# A recursive float32 sum errs by at most about L 2^-24 sum|x| (~5e-4 for
# sum|x| ~ 80); a sum that cancels to near 0 is held by atol, not rtol.
B4_TOL = dict(rtol=1e-5, atol=5e-4)
# B4 in bf16: both sum in float32 and round once to bf16, so they differ by
# one bf16 step (at most 2^-7 |out|) where their float32 sums straddle a
# rounding point; near 0 the float32 orders differ by B4_TOL's atol.
B4_BF16_TOL = dict(rtol=2 ** -7, atol=B4_TOL["atol"])
B4_DESIGN = ("a warp per bag: its indices staged in shared memory, 128 at a "
             "time (four coalesced loads of 32, the next 128 in flight), rows "
             "read as the widest vector that divides the row and the table's "
             "address (D = 18 float32: float2, 9 lanes a row, 3 rows a load "
             "instruction), 8 row loads (__ldg) a lane in flight, float32 "
             "sums of the row groups combined by shuffles")
# DIN's embedding table (V x D float32) and its bags of L: serve_p99 and
# serve_bulk batches
DIN_V, DIN_D, DIN_L, DIN_BATCHES = 10_000_000, 18, 100, (512, 262_144)
# B4 before this design (one thread per output element), (B, mode): ms at
# DIN's f32 shapes on an H100 80GB HBM3 at 700 W (PERF.md, run H)
B4_RUN_H_MS = {(512, "sum"): 0.0382, (512, "mean"): 0.0236,
               (262_144, "sum"): 1.3980, (262_144, "mean"): 1.3977}
# B4 at every branch of its layout (dtype, D, B, L, table offset in
# elements; V = 100,000): float2 / bf16x2 rows of 9 lanes (D = 18), the 4-
# and 2-byte fallbacks (D = 17), float4 and one row a load (D = 128, bf16:
# two rows), passes over a wide row (D = 256), a table 4 bytes off 16-byte
# alignment (4-byte loads at D = 128), L = 1, L over the 128 staged indices
# (300, 130), B = 1.
B4_CASES = (("float32", 18, 1000, 100, 0), ("bf16", 18, 1000, 100, 0),
            ("float32", 17, 1000, 100, 0), ("bf16", 17, 1000, 7, 0),
            ("float32", 128, 1000, 100, 0), ("bf16", 128, 1000, 130, 0),
            ("float32", 256, 1000, 100, 0), ("float32", 128, 1000, 100, 1),
            ("float32", 18, 1000, 1, 0), ("float32", 18, 1000, 300, 0),
            ("float32", 18, 1, 100, 0), ("float32", 256, 1, 1, 0))
# phase 7: last-token logits of the flash and the plain prefill in bf16.
# The two paths round attention outputs to bf16 at other points, and the
# difference grows through 34 layers: on an H100 80GB HBM3 at 700 W it was
# 0.0781 at most (mean 0.0114) with logits up to 5.16, so the limit leaves
# about twice that.  It holds the path's wiring (every layer, head and
# window in place, finite values), not B3's fine numerics: bf16 noise
# through 34 layers hides small faults (phase 7 prints how far a window off
# by one key moves these logits).  B3 itself is held to its plain version
# in float32 in phase 2 and on the path's own inputs after it.
LOGITS_TOL = dict(rtol=0.05, atol=0.15)

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
# and rmat13 (rmat(13, 8, seed=5), phases 8b and 8e) by tools/smoke_digests.py
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
    "rmat13": dict(
        m=55_421, triangles=320_966, kmax=36,
        sha256="94a093e7e9cb7df2072f2c9d2e9c1740816a807afd280453603e34813b134806",
        classes={2: 6892, 3: 5723, 4: 4948, 5: 4005, 6: 3444, 7: 2749,
                 8: 2798, 9: 2605, 10: 2278, 11: 1796, 12: 1528, 13: 1045,
                 14: 1141, 15: 983, 16: 904, 17: 886, 18: 787, 19: 1274,
                 20: 1317, 21: 1563, 22: 1034, 23: 1086, 24: 693, 25: 572,
                 26: 147, 27: 40, 28: 39, 29: 83, 32: 1, 33: 8, 34: 155,
                 35: 271, 36: 2626}),
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


def graph_ms(torch, fn, reps: int) -> float:
    """Device time of one ``fn()`` without the host's cost of a call: ``reps``
    calls captured in one CUDA graph, replayed and timed by CUDA events."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def b1_bound_ms(B: int, E: int, rows_read: int, rows_written: int) -> float:
    """Least time of one fused round: the triangle rows it reads and the
    live rows it writes (12 bytes a row) and the five (B, E) int32 arrays
    (sup, alive, rm in; sup', alive' out), each moved once over the memory
    rate."""
    return (12 * (rows_read + rows_written) + 20 * B * E) \
        / HBM_BYTES_PER_S * 1e3


def pow4_ceil(x: int) -> int:
    """The pow4 capacity the padded launch shapes used (at least 1)."""
    c = 1
    while c < x:
        c *= 4
    return c


def b2_bound(n: int) -> tuple[float, str]:
    """Least time of S = (A A) o A: 2 n^3 int8 operations against n^2 bytes
    read and 4 n^2 written; the larger bounds it."""
    ops = 2 * n ** 3 / INT8_OPS_PER_S * 1e3
    byt = 5 * n * n / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= byt else (byt, "bytes")


def visible_pairs(S: int, window: int | None) -> int:
    """(query, key) pairs a causal attention over S positions computes:
    key j is visible from query i when j <= i and i - window < j."""
    if window is None or window >= S:
        return S * (S + 1) // 2
    return window * (window + 1) // 2 + (S - window) * window


def b3_bound(q, k, window) -> tuple[float, str]:
    """Least time of causal GQA attention: 4 B Hq D flops per visible pair
    over the bf16 tensor-core peak, against q, k, v and o moved once."""
    B, Hq, S, D = q.shape
    ops = 4 * B * Hq * D * visible_pairs(S, window) / BF16_FLOPS * 1e3
    byt = (2 * q.numel() + 2 * k.numel()) * q.element_size() \
        / HBM_BYTES_PER_S * 1e3
    return (ops, "operations") if ops >= byt else (byt, "bytes")


def b4_bound_ms(table, idx) -> float:
    """Least time of an embedding bag: the gathered rows, the indices and
    the output moved once over the memory rate."""
    B, L = idx.shape
    row = table.shape[1] * table.element_size()
    return (B * L * row + B * L * 4 + B * row) / HBM_BYTES_PER_S * 1e3


def b4_traffic(table, idx) -> dict:
    """What the gather moves if every row costs the 32-byte sectors (or the
    64-byte segments) it touches, with the indices and the output moved
    once: information beside the byte bound, which counts each byte once."""
    B, L = idx.shape
    row = table.shape[1] * table.element_size()
    start = table.data_ptr() % 64 + idx.long() * row
    end = start + row - 1
    out = {}
    for unit, name in ((32, "sector"), (64, "segment")):
        n = int((end // unit - start // unit + 1).sum())
        out[f"{name}_bytes"] = unit * n + 4 * B * L + B * row
        out[f"{name}_ms"] = out[f"{name}_bytes"] / HBM_BYTES_PER_S * 1e3
    return out


def ptxas_kernels(log: str) -> dict:
    """Per entry function of a ptxas -v report: registers, spill stores,
    stack frame and static shared memory, in bytes."""
    out = {}
    for chunk in log.split("Compiling entry function '")[1:]:
        name = chunk.split("'", 1)[0]
        num = lambda pat: int((re.search(pat, chunk) or [0, 0])[1])
        out[name] = dict(registers=num(r"Used (\d+) registers"),
                         spill_stores=num(r"(\d+) bytes spill stores"),
                         stack=num(r"(\d+) bytes stack frame"),
                         static_smem=num(r"(\d+) bytes smem"))
    return out


def sass_mma_counts(lib: Path) -> dict:
    """Per kernel of a built library: the HGMMA (floating-point wgmma),
    HMMA (floating-point mma.sync), IGMMA (integer wgmma) and IMMA (integer
    mma.sync) instructions of its SASS, from ``cuobjdump -sass``."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(lib)], capture_output=True,
                          text=True, check=True, timeout=300).stdout
    counts, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1]
            counts[name] = dict(hgmma=0, hmma=0, igmma=0, imma=0)
        elif name is not None:
            for op in ("HGMMA", "HMMA", "IGMMA", "IMMA"):
                counts[name][op.lower()] += op in line
    return counts


def b3_build_check(torch, build, ak) -> dict:
    """Print what ptxas made of every B3 instantiation and its tensor-core
    instructions; raise unless the bf16 D = 256 instantiation runs on tensor
    cores and spills nothing.  Returns that instantiation's figures."""
    regs = ptxas_kernels(build.report("flash_attention"))
    mma = sass_mma_counts(build.target("flash_attention"))
    rows = {}
    for name, r in regs.items():
        m = re.search(r"(tc|f32)_kernelILi(\d+)E", name)
        if m is None:
            continue
        route, n = m[1], int(m[2])
        d, dtype = (n, torch.bfloat16) if route == "tc" else (16 * n,
                                                              torch.float32)
        r.update(mma.get(name, dict(hgmma=0, hmma=0, igmma=0, imma=0)),
                 dynamic_smem=ak.smem_bytes(d, dtype))
        rows[(route, d)] = r
    for (route, d), r in sorted(rows.items()):
        say(f"[1]   B3 {'bf16 tensor-core' if route == 'tc' else 'float32'} "
            f"D <= {d}: {r['registers']} registers, {r['spill_stores']} "
            f"bytes spill stores, {r['stack']} bytes stack, "
            f"{r['dynamic_smem']} bytes dynamic shared memory, HGMMA "
            f"{r['hgmma']}, HMMA {r['hmma']}")
    top = rows.get(("tc", 256))
    if top is None:
        raise AssertionError("no bf16 D = 256 instantiation of B3 in the "
                             "ptxas report")
    if top["hgmma"] + top["hmma"] == 0:
        raise AssertionError("B3's bf16 D = 256 instantiation has no tensor-"
                             "core instruction in its SASS")
    if top["spill_stores"]:
        raise AssertionError(f"B3's bf16 D = 256 instantiation spills "
                             f"{top['spill_stores']} bytes")
    return top


def b1b2_build_check(build) -> dict:
    """Print what ptxas made of B1 and B2 and B2's int8 MMA instructions;
    raise if either spills or B2 has no int8 MMA instruction.  Returns each
    kernel's figures."""
    out = {}
    for src, trace, int8 in (("frontier_peel", B1_TRACE_NAME, False),
                             ("triangle_count", B2_TRACE_NAME, True)):
        regs = ptxas_kernels(build.report(src))
        mma = sass_mma_counts(build.target(src))
        for name, r in regs.items():
            if trace not in name:
                continue
            r.update(mma.get(name, dict(hgmma=0, hmma=0, igmma=0, imma=0)))
            say(f"[1]   {src} {trace}: {r['registers']} registers, "
                f"{r['spill_stores']} bytes spill stores, {r['stack']} bytes "
                f"stack, {r['static_smem']} bytes static shared memory, "
                f"IGMMA {r['igmma']}, IMMA {r['imma']}, HGMMA {r['hgmma']}, "
                f"HMMA {r['hmma']}")
            if r["spill_stores"]:
                raise AssertionError(f"{src} spills {r['spill_stores']} "
                                     f"bytes")
            if int8 and r["igmma"] + r["imma"] == 0:
                raise AssertionError(f"{src} has no int8 MMA instruction in "
                                     f"its SASS")
            out[src] = r
        if src not in out:
            raise AssertionError(f"no {trace} in the ptxas report of {src}")
    return out


def b4_build_check(build) -> dict:
    """Print what ptxas made of every B4 instantiation and of the gather
    probe; raise if one spills.  Returns the figures by (function, dtype,
    load bytes)."""
    out = {}
    for name, r in ptxas_kernels(build.report("embedding_bag")).items():
        m = re.search(r"(embedding_bag_kernel|gather_probe)"
                      r"I(f|13__nv_bfloat16)Li(\d+)E", name)
        if m is None:
            continue
        key = (m[1], "float32" if m[2] == "f" else "bf16", int(m[3]))
        say(f"[1]   B4 {key[0]} {key[1]} {key[2]}-byte loads: "
            f"{r['registers']} "
            f"registers, {r['spill_stores']} bytes spill stores, "
            f"{r['stack']} bytes stack, {r['static_smem']} bytes static "
            f"shared memory")
        if r["spill_stores"]:
            raise AssertionError(f"B4 {key} spills {r['spill_stores']} bytes")
        out[key] = r
    if not any(k[0] == "embedding_bag_kernel" for k in out):
        raise AssertionError("no embedding_bag_kernel in the ptxas report")
    return out


def row_key(torch, rows):
    """One int64 per (e0, e1, e2) row (ids below 2^21), for comparing row
    lists as multisets."""
    r = rows.to(torch.int64)
    return (r[:, 0] << 42) | (r[:, 1] << 21) | r[:, 2]


def check_b1_live(torch, fk, fref, args, n_rows, where: str) -> dict:
    """B1's live-row round against its plain version on the same inputs:
    sup' and alive' exactly, each lane's compacted rows as a multiset,
    n_rows_out exactly.  Returns the rows read and written and the max
    abs error over sup', alive' and n_rows_out (1 for a lane whose rows
    differ)."""
    sup, alive, rm, tris = args
    tris_out = torch.full_like(tris, -1)
    n_out = torch.full_like(n_rows, -1)
    got = fk.fused_round_live(sup, alive, rm, tris, n_rows, tris_out, n_out)
    want_s, want_a, want_rows, want_n = fref.fused_round_live(
        sup, alive, rm, tris, n_rows)
    torch.cuda.synchronize()
    errs = {"sup'": int((got[0] - want_s).abs().max()),
            "alive'": int((got[1] - want_a).abs().max()),
            "n_rows_out": int((n_out - want_n).abs().max()),
            "rows": 0}
    for b, (c, c_got) in enumerate(zip(want_n.tolist(), n_out.tolist())):
        if c != c_got or not torch.equal(
                torch.sort(row_key(torch, tris_out[b, :c]))[0],
                torch.sort(row_key(torch, want_rows[b, :c]))[0]):
            errs["rows"] = 1
    if any(errs.values()):
        raise AssertionError(f"B1 fused_round_live differs from the plain "
                             f"version {where}: max abs errors {errs}")
    return dict(rows_read=int(n_rows.clamp(0, tris.shape[1]).sum()),
                rows_written=int(want_n.sum()),
                max_abs_err=float(max(errs.values())))


class Probe:
    """Wraps a kernel wrapper for the main path: brackets every call with
    CUDA events (the device's clock, host gaps between the events included),
    sums the bound of every call, and keeps the inputs of the largest call
    of each ``group`` (a key of the call's arguments) to check and time the
    kernel on afterwards.  ``note`` records something of each call right
    after it (kept in ``notes``); ``keep`` says what to keep of the largest
    call's arguments (default: the arguments themselves; a buffer that the
    path overwrites later must be cloned)."""

    def __init__(self, torch, module, name: str, size, bound,
                 group=lambda *a, **kw: None, note=None, keep=None):
        self.torch, self.module, self.name = torch, module, name
        self.fn = getattr(module, name)
        self.size, self.bound, self.group = size, bound, group
        self.note, self.keep = note, keep
        self.events, self.bound_ms, self.notes = [], 0.0, []
        self.largest: dict = {}
        self.sizes: dict = {}
        self.shapes: dict = {}
        setattr(module, name, self)

    def __call__(self, *args, **kw):
        ev = self.torch.cuda.Event
        start, end = ev(enable_timing=True), ev(enable_timing=True)
        start.record()
        out = self.fn(*args, **kw)
        end.record()
        self.events.append((start, end))
        self.bound_ms += self.bound(*args, **kw)
        if self.note is not None:
            self.notes.append(self.note(*args, **kw))
        key = tuple(tuple(a.shape) for a in args) + tuple(sorted(kw.items()))
        self.shapes[key] = self.shapes.get(key, 0) + 1
        g, size = self.group(*args, **kw), self.size(*args, **kw)
        if g not in self.largest or size > self.sizes[g]:
            kept = args if self.keep is None else self.keep(*args, **kw)
            self.largest[g], self.sizes[g] = (kept, kw), size
        return out

    def close(self) -> float:
        """Restore the wrapper; return the summed device ms of all calls."""
        setattr(self.module, self.name, self.fn)
        self.torch.cuda.synchronize()
        return sum(s.elapsed_time(e) for s, e in self.events)


def check_b4(torch, bk, bref, table, idx, mode: str, where: str) -> float:
    """B4 against its plain version on the same inputs, within B4_TOL
    (float32) or B4_BF16_TOL (bf16); returns the max abs error."""
    tol = B4_TOL if table.dtype == torch.float32 else B4_BF16_TOL
    got = bk.embedding_bag(table, idx, mode=mode)
    want = bref.embedding_bag(table, idx, mode=mode)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    if got.dtype != want.dtype or got.shape != want.shape or \
            not torch.allclose(got.float(), want.float(), **tol):
        raise AssertionError(f"B4 embedding_bag differs from its plain "
                             f"version {where} {mode}: max abs err {err}")
    return err


def b4_phase(torch, F, bk, bref, gen, builds, dev) -> dict:
    """Phase 2 for B4: every case of B4_CASES in sum and mean, then DIN's
    table (10,000,000 x 18, float32 and bf16) at serve_p99 (512 bags) and
    serve_bulk (262,144 bags) of 100: checked, timed beside run H, the plain
    version, F.embedding_bag, the byte bound, the sector and segment traffic
    (derived from the shapes, not measured) and the gather probe's floor.  The kernel is
    also timed in a CUDA graph (its device time without the host's cost of a
    call), and so is the probe.  Returns the kernels-line entry (serve_bulk,
    float32, mean)."""
    dtypes = {"float32": torch.float32, "bf16": torch.bfloat16}
    for dname, D, B, L, offset in B4_CASES:
        V = 100_000
        flat = torch.randn(V * D + offset, generator=gen, device=dev)
        table = flat.to(dtypes[dname])[offset:].view(V, D)
        idx = torch.randint(0, V, (B, L), generator=gen, device=dev,
                            dtype=torch.int32)
        lay = bk.layout(D, table.element_size(), table.data_ptr())
        where = f"at {dname} D={D} B={B} L={L} offset {offset}"
        errs = [check_b4(torch, bk, bref, table, idx, mode, where)
                for mode in bk.MODES]
        say(f"[2] B4 embedding_bag {dname} D={D} B={B} L={L} table offset "
            f"{offset}: {lay.vec}-byte loads, {lay.chunks} a row, "
            f"{lay.rows} rows a load, {lay.passes} pass(es); max abs err "
            f"sum {errs[0]:.3g}, mean {errs[1]:.3g}")
    table = torch.randn((DIN_V, DIN_D), generator=gen, device=dev)
    out = None
    for B in DIN_BATCHES:
        idx = torch.randint(0, DIN_V, (B, DIN_L), generator=gen, device=dev,
                            dtype=torch.int32)
        for dname, dt in dtypes.items():
            tbl = table.to(dt)
            traffic = b4_traffic(tbl, idx)
            bound = b4_bound_ms(tbl, idx)
            floor = graph_ms(torch, lambda: bk.gather_probe(tbl, idx), 20)
            say(f"[2] B4 gather probe V={DIN_V:,} D={DIN_D} {dname} B={B} "
                f"L={DIN_L}: floor {floor:.4f} ms; bytes bound {bound:.4f} "
                f"ms; derived from the shapes: 32-byte sectors "
                f"{traffic['sector_bytes']:,} bytes = "
                f"{traffic['sector_ms']:.4f} ms, 64-byte segments "
                f"{traffic['segment_bytes']:,} bytes = "
                f"{traffic['segment_ms']:.4f} ms at 3.35 TB/s")
            for mode in bk.MODES:
                err = check_b4(torch, bk, bref, tbl, idx, mode,
                               f"at DIN {dname} B={B}")
                ms = time_ms(torch, lambda: bk.embedding_bag(
                    tbl, idx, mode=mode), 20)
                device = graph_ms(torch, lambda: bk.embedding_bag(
                    tbl, idx, mode=mode), 20)
                plain = time_ms(torch, lambda: bref.embedding_bag(
                    tbl, idx, mode=mode), 5)
                lib = time_ms(torch, lambda: F.embedding_bag(
                    idx, tbl, mode=mode), 20)
                run_h = B4_RUN_H_MS.get((B, mode)) if dname == "float32" \
                    else None
                tol = B4_TOL if dname == "float32" else B4_BF16_TOL
                say(f"[2] B4 embedding_bag V={DIN_V:,} D={DIN_D} {dname} "
                    f"B={B} L={DIN_L} {mode}: max abs err {err:.3g} (tol "
                    f"{tol}); kernel {ms:.4f} ms (in a CUDA graph "
                    f"{device:.4f} ms; run H "
                    f"{'none' if run_h is None else f'{run_h:.4f} ms'}), "
                    f"plain {plain:.4f} ms, F.embedding_bag {lib:.4f} ms, "
                    f"bound {bound:.4f} ms (bytes), gather_floor_ms "
                    f"{floor:.4f}")
                if (B, dname, mode) == (DIN_BATCHES[-1], "float32", "mean"):
                    lay = bk.layout(DIN_D, 4, tbl.data_ptr())
                    out = dict(
                        name="embedding_bag.embedding_bag", route="cuda",
                        source="src/repro_torch/csrc/embedding_bag.cu",
                        replaces="src/repro/kernels/embedding_bag/"
                        "kernel.py:53", launches=0, max_abs_err=err, ms=ms,
                        plain_ms=plain, bound_ms=bound, bound_by="bytes",
                        library_ms=lib,
                        shape=[*tbl.shape, B, DIN_L], mode=mode,
                        design=B4_DESIGN, gather_floor_ms=floor,
                        traffic_derived_from_shapes=traffic, graph_ms=device,
                        build=builds.get(("embedding_bag_kernel", "float32",
                                          lay.vec)),
                        note="no model path of the JAX package reaches "
                        "embedding_bag; timed at DIN serve_bulk")
            del tbl
        del idx
    return out


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


# phase 5e's child: 5d's call, journaled at every round and level, killed by
# a "kill" rule at the dispatch of level K.  It imports only repro_torch.
KILL_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.core import faults
from repro_torch.core.peel import truss_decompose
from repro_torch.data.graphgen import rmat

journal, budget, k_kill, device = sys.argv[1:5]
n, edges = rmat(15, 8, seed=5)
faults.install(faults.FaultPlan([faults.FaultRule(
    site=faults.DISPATCH, kind="kill",
    where={"stage": "td", "k": int(k_kill)})]))
truss_decompose(n, edges, engine="top-down", memory_budget=int(budget),
                checkpoint_dir=journal, checkpoint_every=1, device=device)
print("the child was not killed")
"""

# phase 5f: injected OOM plans, (label, engine, rule, retries expected)
RETRY_PLANS = (
    ("stage-1 dispatch, two lane splits", "bottom-up",
     dict(site="dispatch", where={"stage": 1}, times=2), 2),
    ("stage-2 finalize", "bottom-up",
     dict(site="finalize", where={"stage": 2}), 1),
    ("top-down level", "top-down",
     dict(site="dispatch", where={"stage": "td"}), 1),
    ("support", "top-down", dict(site="support"), 1),
)


def kill_and_resume(truss_decompose, ckpt, run_phase, n, edges, budget,
                    phi_want, dev) -> dict:
    """Phase 5e: a child process runs the budgeted top-down call with a
    journal and is SIGKILLed at the dispatch of the level halfway down the
    classes of ``phi_want``; this process resumes the same call from the
    journal.  The child must end by SIGKILL, the resumed phi equal
    ``phi_want``, and ``resumed_round`` be the last journaled level."""
    ks = sorted(set(np.unique(phi_want).tolist()) - {2}, reverse=True)
    k_kill = ks[len(ks) // 2]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_journal_") as d:
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        child = subprocess.run(
            [sys.executable, "-c", KILL_CHILD, d, str(budget), str(k_kill),
             str(dev)], env=env, capture_output=True, text=True,
            timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(
                f"5e: the child exited with {child.returncode}, not by "
                f"SIGKILL: {child.stdout[-800:]} {child.stderr[-2000:]}")
        _, meta = ckpt.restore(d)
        if meta["stage"] != "td" or meta["index"] <= k_kill:
            raise AssertionError(f"5e: the newest snapshot is "
                                 f"{meta['stage']} {meta['index']}, not a "
                                 f"level above {k_kill}")
        phi, st = run_phase("5e resume rmat15", lambda: truss_decompose(
            n, edges, engine="top-down", memory_budget=budget,
            with_stats=True, checkpoint_dir=d, resume=True, device=dev))
    out = dict(k_kill=k_kill, levels=len(ks), child_s=round(child_s, 3),
               last_journaled=meta["index"], resumed_round=st.resumed_round,
               checkpoints=st.checkpoints, retries=st.retries)
    say(f"[5e] child killed by SIGKILL at level {k_kill} of {len(ks)} "
        f"classes after {child_s:.3f} s; resumed {out}")
    if not np.array_equal(phi, phi_want):
        raise AssertionError("5e: the resumed phi differs")
    if st.resumed_round != meta["index"] or st.checkpoints <= 0:
        raise AssertionError(f"5e: resumed_round {st.resumed_round} (the "
                             f"journal's last level {meta['index']}), "
                             f"checkpoints {st.checkpoints}")
    return out


def retry_ladder(torch, faults, truss_decompose, estimate_working_set,
                 build_graph, rmat, check_b1, dev) -> dict:
    """Phase 5f on R-MAT scale 13, seed 5: a genuine allocator OOM must be
    a ``torch.OutOfMemoryError`` that ``faults.is_retryable`` accepts, and
    the B1 launch after it (``check_b1``) must equal its plain version;
    then the budgeted drivers under each of ``RETRY_PLANS`` must give the
    in-memory phi with the planned retries."""
    n, edges = rmat(13, 8, seed=5)
    budget = estimate_working_set(build_graph(n, edges)) // 16
    phi_want = truss_decompose(n, edges, device=dev)
    total = torch.cuda.mem_get_info()[1]
    try:
        torch.empty(total + (1 << 30), dtype=torch.uint8, device=dev)
    except torch.OutOfMemoryError as exc:
        oom = (type(exc).__name__, str(exc).split("\n")[0][:160],
               faults.is_retryable(exc))
    else:
        raise AssertionError("5f: an allocation past the card's memory "
                             "did not raise")
    say(f"[5f] genuine OOM: {oom[0]}: {oom[1]}; retryable {oom[2]}")
    if not oom[2]:
        raise AssertionError("5f: faults.is_retryable refused a device OOM")
    check_b1("after the device OOM")
    out = dict(oom_retryable=oom[2], plans=[])
    for label, engine, rule, retries in RETRY_PLANS:
        plan = faults.FaultPlan([faults.FaultRule(kind="oom", **rule)])
        t0 = time.perf_counter()
        with faults.active(plan):
            phi, st = truss_decompose(n, edges, engine=engine,
                                      memory_budget=budget, with_stats=True,
                                      device=dev)
        row = dict(plan=label, engine=engine, fired=len(plan.log),
                   retries=st.retries, degraded=st.degraded,
                   wall_s=round(time.perf_counter() - t0, 3))
        say(f"[5f] {row}")
        if not np.array_equal(phi, phi_want):
            raise AssertionError(f"5f: phi differs under the plan {label}")
        if (st.retries, st.degraded, len(plan.log)) != (retries, 0, retries):
            raise AssertionError(f"5f: plan {label}: {row}, expected "
                                 f"{retries} retries")
        out["plans"].append(row)
    return out


# the graph store's counters of OocStats (4c, 5g, 5h)
IO_COUNTERS = ("chunk_reads", "chunk_writes", "bytes_spilled",
               "prefetch_hits", "prefetch_misses", "tri_spill_rows",
               "tri_reload_peak_rows")


def store_budget(g) -> tuple[int, int, int]:
    """The disk store's regime of the reference benchmark's disk rows
    (``benchmarks/run.py``, ``table4disk``): the packed graph's bytes (its
    eight arrays), a host budget of an eighth of them, and chunks of a
    sixteenth of the budget, at least 4,096 bytes."""
    graph_bytes = sum(int(getattr(g, a).nbytes) for a in g._ARRAYS)
    host_budget = graph_bytes // 8
    return graph_bytes, host_budget, max(host_budget // 16, 4096)


def io_row(st, peak: int) -> dict:
    row = {k: int(getattr(st, k)) for k in IO_COUNTERS}
    row.update(prefetch_hit_rate=round(st.prefetch_hit_rate, 4),
               peak_resident_bytes=int(peak))
    return row


def edit_batch(n: int, edges: np.ndarray, b: int) -> list:
    """A batch of b edits as ``benchmarks/run.py::table5_maintenance`` draws
    them, from a fresh ``default_rng(9)``: b // 2 deletions of edges of the
    canonical list ``edges``, then insertions of new uniform pairs."""
    rng = np.random.default_rng(9)
    present = {tuple(e) for e in np.asarray(edges).tolist()}
    steps = [("delete", int(u), int(v))
             for u, v in (edges[i] for i in rng.choice(
                 len(edges), b // 2, replace=False))]
    while len(steps) < b:
        u, v = (int(x) for x in rng.integers(0, n, 2))
        lo, hi = min(u, v), max(u, v)
        if lo == hi or (lo, hi) in present:
            continue
        present.add((lo, hi))
        steps.append(("insert", lo, hi))
    return steps


# phase 5h's child: bottom-up on rmat13 through a disk store, journaled at
# every round, killed by a "kill" rule at the nth chunk write.  It imports
# only repro_torch.
SPILL_KILL_CHILD = r"""
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.core import faults
from repro_torch.core.peel import truss_decompose
from repro_torch.core.store import ChunkedDiskStore
from repro_torch.data.graphgen import rmat

journal, store_dir, budget, host_budget, chunk_bytes, nth, device = \
    sys.argv[1:8]
n, edges = rmat(13, 8, seed=5)
faults.install(faults.FaultPlan([faults.FaultRule(
    site=faults.CHUNK_WRITE, kind="kill", nth=int(nth))]))
with ChunkedDiskStore(store_dir, host_memory_budget=int(host_budget),
                      chunk_bytes=int(chunk_bytes)) as store:
    truss_decompose(n, edges, engine="bottom-up", memory_budget=int(budget),
                    store=store, checkpoint_dir=journal, checkpoint_every=1,
                    device=device)
print("the child was not killed")
"""


def store_phases(truss_decompose, estimate_working_set, build_graph, rmat,
                 ChunkedDiskStore, ckpt, run_phase, phase_launches,
                 dev) -> dict:
    """Phases 5g and 5h on R-MAT scale 13, seed 5, at
    ``estimate_working_set // 16``, through a disk store in the regime of
    :func:`store_budget`.

    5g: budgeted top-down with the locality partitioner; phi must equal
    the in-memory phi, ``partitioned_support`` must have written and read
    chunks, the store must have held no more than its budget, and B1 must
    have launched.  5h: an uninterrupted journaled bottom-up run through
    the store counts its chunk writes; a child process (importing only
    ``repro_torch``) runs the same call and is SIGKILLed by a ``kill`` rule
    at half that many writes, leaving its ``*.bin`` files; this process
    resumes the call with a new store on the same directory, which must
    sweep the dead run's files, and the resumed phi must equal the
    in-memory one with ``resumed_round >= 0``.
    """
    n, edges = rmat(13, 8, seed=5)
    g = build_graph(n, edges)
    budget = estimate_working_set(g) // 16
    graph_bytes, host_budget, chunk_bytes = store_budget(g)
    store_kw = dict(host_memory_budget=host_budget, chunk_bytes=chunk_bytes)
    phi_want = truss_decompose(n, edges, device=dev)
    out = dict(graph="rmat13", m=g.m, memory_budget=budget,
               graph_bytes=graph_bytes, **store_kw)

    tag = "5g locality top-down rmat13 disk store"
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as sd, \
            ChunkedDiskStore(sd, **store_kw) as store:
        phi, st = run_phase(tag, lambda: truss_decompose(
            n, edges, engine="top-down", memory_budget=budget,
            partitioner="locality", store=store, with_stats=True,
            device=dev))
        peak = store.stats.peak_resident_bytes
    out["5g"] = dict(rounds=st.rounds, tri_locality=round(st.tri_locality, 4),
                     launches=phase_launches[tag]["B1"], **io_row(st, peak))
    say(f"[5g] {out['5g']}")
    if not np.array_equal(phi, phi_want):
        raise AssertionError("5g: the disk-store locality top-down phi "
                             "differs from the in-memory phi")
    if st.chunk_writes == 0 or st.chunk_reads == 0 or peak > host_budget:
        raise AssertionError(f"5g: partitioned_support wrote "
                             f"{st.chunk_writes} and read {st.chunk_reads} "
                             f"chunks, peak {peak} of a {host_budget} budget")
    if phase_launches[tag]["B1"] == 0:
        raise AssertionError("5g never launched the B1 kernel")

    with tempfile.TemporaryDirectory(prefix="chip_smoke_spill_") as top:
        def call(journal, store, **kw):
            return truss_decompose(
                n, edges, engine="bottom-up", memory_budget=budget,
                store=store, checkpoint_dir=os.path.join(top, journal),
                checkpoint_every=1, with_stats=True, device=dev, **kw)

        with ChunkedDiskStore(os.path.join(top, "full"), **store_kw) as st_:
            phi_full, full = run_phase(
                "5h uninterrupted bottom-up rmat13 disk store",
                lambda: call("full-journal", st_))
        nth = full.chunk_writes // 2
        sd = os.path.join(top, "store")
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        child = subprocess.run(
            [sys.executable, "-c", SPILL_KILL_CHILD,
             os.path.join(top, "journal"), sd, str(budget), str(host_budget),
             str(chunk_bytes), str(nth), str(dev)], env=env,
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(
                f"5h: the child exited with {child.returncode}, not by "
                f"SIGKILL: {child.stdout[-800:]} {child.stderr[-2000:]}")
        dead = {f for f in os.listdir(sd) if f.endswith((".bin", ".tmp"))}
        if not any(f.endswith(".bin") for f in dead):
            raise AssertionError("5h: the killed child left no chunk file")
        _, meta = ckpt.restore(os.path.join(top, "journal"))
        tag = "5h resume bottom-up rmat13 disk store"
        with ChunkedDiskStore(sd, **store_kw) as store:
            swept = not dead & set(os.listdir(sd))
            phi_r, rst = run_phase(tag, lambda: call("journal", store,
                                                     resume=True))
            left = dead & set(os.listdir(sd))
            peak = store.stats.peak_resident_bytes
    out["5h"] = dict(
        chunk_writes_uninterrupted=full.chunk_writes, kill_at_write=nth,
        child_s=round(child_s, 3), dead_files=len(dead),
        journal_stage=meta["stage"], journal_index=meta["index"],
        resumed_round=rst.resumed_round, swept_at_open=swept,
        launches=phase_launches[tag]["B1"], **io_row(rst, peak))
    say(f"[5h] child killed by SIGKILL at chunk write {nth} of "
        f"{full.chunk_writes} after {child_s:.3f} s, leaving {len(dead)} "
        f"files; resumed {out['5h']}")
    if not (np.array_equal(phi_full, phi_want)
            and np.array_equal(phi_r, phi_want)):
        raise AssertionError("5h: the uninterrupted or the resumed phi "
                             "differs from the in-memory phi")
    if rst.resumed_round < 0 or not swept or left or peak > host_budget:
        raise AssertionError(f"5h: resumed_round {rst.resumed_round}, "
                             f"dead files swept at open {swept}, left "
                             f"{sorted(left)[:4]}, peak {peak} of "
                             f"{host_budget}")
    if phase_launches[tag]["B1"] == 0:
        raise AssertionError("5h: the resumed run never launched B1")
    return out


def b1_probe(torch, fk) -> Probe:
    """The B1 wrapper's probe on a path: each call's rows read and written
    are summed on the device (known there only) and read at the end; the
    largest call's inputs are kept (cloned: the loops reuse the buffers)."""
    return Probe(torch, fk, "fused_round_live",
                 size=lambda s, a, r, t, n, to, no: s.numel() + t.numel(),
                 bound=lambda *a: 0.0,
                 note=lambda s, a, r, t, n, to, no: (
                     s.shape[0], s.shape[1], t.shape[1], n.sum(), no.sum()),
                 keep=lambda s, a, r, t, n, to, no: (s, a, r, t.clone(),
                                                     n.clone()))


def b1_rows(torch, probe) -> dict:
    """Rows read and written over a probe's B1 calls, and their bound."""
    reads = torch.stack([nt[3] for nt in probe.notes]).tolist()
    writes = torch.stack([nt[4] for nt in probe.notes]).tolist()
    return dict(
        rows_read=int(sum(reads)), rows_written=int(sum(writes)),
        padded_rows=sum(B * pow4_ceil(T) for B, _, T, _, _ in probe.notes),
        bound_ms=sum(b1_bound_ms(B, E, r, w) for (B, E, _, _, _), r, w
                     in zip(probe.notes, reads, writes)))


# phases 8a-8e: what the JAX package gives for the same calls, printed by
# tools/smoke_digests.py (see its docstring; made on the CPU)
MAINT_DIGESTS = {
    "8a_b1": dict(
        m=234_004, edits_applied=1, maintain_levels=0, affected_edges=0,
        sha256="29f6c5c9def131d3088fb6105e0610d35843387632f2abf4aef9343beacb8497"),
    "8a_b64": dict(
        m=234_003, edits_applied=64, maintain_levels=171, affected_edges=48_129,
        sha256="a8605711cb88a07b61621bdd67d506cb0092b7da706d99e7081d40ae43224625"),
    "8b": dict(
        m=55_421, edits_applied=16, maintain_levels=46, affected_edges=4_217,
        chunk_writes=630, bytes_spilled=6_730_444,
        sha256="2c2844e69221424d304f1fbb3302b3101add42ff28286b5eab2b84db5667dc13"),
    "8c": dict(
        cmax=165, kmax=95, vt=148, vc=789, et=9_410, ec=91_360,
        cct=0.8697008877966349, ccc=0.3985649778721447,
        core_sha256="0513532c86fd05ce42142f9b1e6f085eba25f8f0797c096e5f8b0a996ecad6d8"),
    "8e": dict(part_budget=6_927, rounds=24, scans=228),
}


def check_maint(where: str, res, want: dict) -> None:
    """A maintenance result against the reference's phi digest and
    counters."""
    st = res.stats
    got = dict(m=res.graph.m, sha256=hashlib.sha256(
        np.asarray(res.phi).astype(np.int64).tobytes()).hexdigest(),
        edits_applied=st.edits_applied, maintain_levels=st.maintain_levels,
        affected_edges=st.affected_edges)
    got.update({k: int(getattr(st, k)) for k in want if k not in got})
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise AssertionError(f"{where}: differs from the JAX package's "
                             f"maintenance: {diff}")


def edit_stream(truss_maintain, truss_decompose, run_phase, phase_walls,
                phase_launches, n, edges, phi0, dev) -> dict:
    """Phase 8a on R-MAT scale 15: ``truss_maintain`` of
    :func:`edit_batch`'s b = 1 and b = 64 edits from phase 4a's phi, each
    followed by a recompute of the maintained edge list on the card.  The
    maintained phi must equal the recompute bit for bit and the JAX
    package's digest (``MAINT_DIGESTS``); at b = 1 the recompute must take
    at least 5x the maintenance's wall (the reference's ``table5maint``
    gate), and at b = 64 B1 must have launched."""
    out = {}
    for b in (1, 64):
        steps = edit_batch(n, edges, b)
        tag, rtag = f"8a maintain b={b} rmat15", f"8a recompute b={b} rmat15"
        res = run_phase(tag, lambda: truss_maintain((n, edges), phi0, steps,
                                                    device=dev))
        phi_r = run_phase(rtag, lambda: truss_decompose(
            res.graph.n, res.graph.edges, device=dev))
        st = res.stats
        row = dict(b=b, m=res.graph.m, edits_applied=st.edits_applied,
                   maintain_levels=st.maintain_levels,
                   affected_edges=st.affected_edges,
                   wall_s=round(phase_walls[tag], 3),
                   recompute_s=round(phase_walls[rtag], 3),
                   speedup_vs_recompute=round(
                       phase_walls[rtag] / phase_walls[tag], 2),
                   launches=phase_launches[tag]["B1"])
        out[f"b{b}"] = row
        say(f"[8a] {row}")
        if not np.array_equal(res.phi, phi_r):
            raise AssertionError(f"8a: the maintained phi differs from the "
                                 f"recompute at b={b}")
        check_maint(f"8a b={b}", res, MAINT_DIGESTS[f"8a_b{b}"])
    if out["b64"]["launches"] == 0:
        raise AssertionError("8a: the b=64 maintenance never launched B1")
    if out["b1"]["speedup_vs_recompute"] < 5:
        raise AssertionError(f"8a: speedup_vs_recompute "
                             f"{out['b1']['speedup_vs_recompute']} < 5 at "
                             f"b=1")
    return out


# phase 8b's child: maintenance of 16 edits on rmat13 through a disk store,
# journaled at every edit, killed by a "kill" rule at the "maintain" site of
# edit K.  It imports only repro_torch.
MAINT_KILL_CHILD = r"""
import json
import sys
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.core import faults
from repro_torch.core.maintain import truss_maintain
from repro_torch.core.store import ChunkedDiskStore
from repro_torch.data.graphgen import rmat

journal, store_dir, inputs, host_budget, chunk_bytes, k_edit, device = \
    sys.argv[1:8]
n, edges = rmat(13, 8, seed=5)
phi0 = np.load(inputs + "/phi0.npy")
with open(inputs + "/steps.json") as f:
    steps = [tuple(s) for s in json.load(f)]
faults.install(faults.FaultPlan([faults.FaultRule(
    site=faults.MAINTAIN, kind="kill", where={"edit": int(k_edit)})]))
with ChunkedDiskStore(store_dir, host_memory_budget=int(host_budget),
                      chunk_bytes=int(chunk_bytes)) as store:
    truss_maintain((n, edges), phi0, steps, store=store,
                   checkpoint_dir=journal, checkpoint_every=1, device=device)
print("the child was not killed")
"""
MAINT_KILL_EDIT = 8


def maintain_kill_and_resume(truss_maintain, truss_decompose, build_graph,
                             rmat, ChunkedDiskStore, faults, ckpt,
                             run_phase, phase_launches, dev) -> dict:
    """Phase 8b on R-MAT scale 13, seed 5: 16 edits of :func:`edit_batch`
    maintained through a disk store in :func:`store_budget`'s regime,
    journaled every edit.  The uninterrupted run's phi and write counters
    must equal the JAX package's (``MAINT_DIGESTS``).  A child (importing
    only ``repro_torch``) runs the same call and is SIGKILLed before edit
    ``MAINT_KILL_EDIT``; this process resumes it on the same journal with a
    new store on the child's directory: phi equal to the uninterrupted
    run's, ``resumed_round`` the edit before the kill, and the ``maintain``
    site reached only by the edits after it."""
    n, edges = rmat(13, 8, seed=5)
    g = build_graph(n, edges)
    _, host_budget, chunk_bytes = store_budget(g)
    store_kw = dict(host_memory_budget=host_budget, chunk_bytes=chunk_bytes)
    phi0 = truss_decompose(n, edges, device=dev)
    check_digest("rmat13", phi0)
    steps = edit_batch(n, edges, 16)
    out = dict(graph="rmat13", m=g.m, edits=len(steps), **store_kw)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_maint_") as top:
        def call(journal, store, **kw):
            return truss_maintain((n, edges), phi0, steps, store=store,
                                  checkpoint_dir=os.path.join(top, journal),
                                  checkpoint_every=1, device=dev, **kw)

        tag = "8b uninterrupted maintain rmat13 disk store"
        with ChunkedDiskStore(os.path.join(top, "full"), **store_kw) as st_:
            full = run_phase(tag, lambda: call("full-journal", st_))
            peak = st_.stats.peak_resident_bytes
        check_maint("8b", full, MAINT_DIGESTS["8b"])
        out["uninterrupted"] = dict(
            maintain_levels=full.stats.maintain_levels,
            affected_edges=full.stats.affected_edges,
            launches=phase_launches[tag]["B1"], **io_row(full.stats, peak))
        np.save(os.path.join(top, "phi0.npy"), phi0)
        with open(os.path.join(top, "steps.json"), "w") as f:
            json.dump(steps, f)
        sd = os.path.join(top, "store")
        t0 = time.perf_counter()
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        child = subprocess.run(
            [sys.executable, "-c", MAINT_KILL_CHILD,
             os.path.join(top, "journal"), sd, top, str(host_budget),
             str(chunk_bytes), str(MAINT_KILL_EDIT), str(dev)], env=env,
            capture_output=True, text=True, timeout=600)
        child_s = time.perf_counter() - t0
        if child.returncode != -signal.SIGKILL:
            raise AssertionError(
                f"8b: the child exited with {child.returncode}, not by "
                f"SIGKILL: {child.stdout[-800:]} {child.stderr[-2000:]}")
        _, meta = ckpt.restore(os.path.join(top, "journal"))
        # counts every maintain check of the resume; fires never
        seen = faults.FaultRule(site=faults.MAINTAIN, kind="error",
                                nth=1 << 30)
        tag = "8b resume maintain rmat13 disk store"
        with ChunkedDiskStore(sd, **store_kw) as store, \
                faults.active(faults.FaultPlan([seen])):
            res = run_phase(tag, lambda: call("journal", store, resume=True))
            peak = store.stats.peak_resident_bytes
    out["resume"] = dict(
        kill_at_edit=MAINT_KILL_EDIT, child_s=round(child_s, 3),
        journal_stage=meta["stage"], journal_index=meta["index"],
        resumed_round=res.stats.resumed_round, edits_replayed=seen.seen,
        launches=phase_launches[tag]["B1"], **io_row(res.stats, peak))
    say(f"[8b] {out}")
    if not np.array_equal(res.phi, full.phi) or \
            not np.array_equal(res.graph.edges, full.graph.edges):
        raise AssertionError("8b: the resumed phi or graph differs from the "
                             "uninterrupted run's")
    want = MAINT_KILL_EDIT - 1
    if (meta["stage"], meta["index"], res.stats.resumed_round,
            seen.seen) != ("maint", want, want, len(steps) - want - 1):
        raise AssertionError(f"8b: journal {meta['stage']} "
                             f"{meta['index']}, resumed_round "
                             f"{res.stats.resumed_round}, {seen.seen} edits "
                             f"replayed; expected edits {want + 1}-"
                             f"{len(steps) - 1} only")
    return out


def table6(core_decompose, cmax_core, clustering_coefficient,
           incident_vertices, canonical_edges, run_phase, n, edges, phi,
           dev) -> dict:
    """Phase 8c, Table 6 on R-MAT scale 17: the core numbers
    (``core_decompose``, against the JAX package's digest) and the
    c_max-core (``cmax_core``) on the card, the k_max-truss from phase 3's
    phi, and the row of ``benchmarks/run.py::table6_truss_vs_core``; every
    number, the clustering coefficients too, must equal the JAX
    package's."""
    core, (cmax, c_edges) = run_phase("8c core decomposition rmat17", lambda: (
        core_decompose(n, edges, device=dev), cmax_core(n, edges, device=dev)))
    kmax = int(phi.max())
    t_edges = canonical_edges(edges, n)[phi == kmax]
    t0 = time.perf_counter()
    got = dict(core_sha256=hashlib.sha256(
        np.asarray(core).astype(np.int64).tobytes()).hexdigest(),
        cmax=cmax, kmax=kmax, vt=len(incident_vertices(t_edges)),
        vc=len(incident_vertices(c_edges)), et=len(t_edges), ec=len(c_edges),
        cct=clustering_coefficient(n, t_edges),
        ccc=clustering_coefficient(n, c_edges))
    host_s = time.perf_counter() - t0
    say(f"[8c] VT/VC={got['vt']}/{got['vc']};ET/EC={got['et']}/{got['ec']};"
        f"kmax/cmax={kmax}/{cmax};CCT/CCC={got['cct']:.2f}/{got['ccc']:.2f} "
        f"(CCT {got['cct']!r}, CCC {got['ccc']!r}; clustering coefficients "
        f"on the host in {host_s:.3f} s)")
    want = MAINT_DIGESTS["8c"]
    if got != want:
        diff = {k: (got[k], want[k]) for k in want if got[k] != want[k]}
        raise AssertionError(f"8c: differs from the JAX package's Table 6 "
                             f"row: {diff}")
    return dict(got, clustering_host_s=round(host_s, 3))


def global_iterate(peel_recompute, list_triangles, run_phase, rdev, g,
                   phi_want, dev) -> dict:
    """Phase 8d: ``peel_recompute`` (every round recounts every support)
    on phase 4's graph and triangle list; phi must equal phase 4a's.  Its
    rounds are its host syncs less the one read that finds no edge alive."""
    tris = list_triangles(g)
    tag = "8d global-iterate peel rmat15"
    s0 = rdev.SYNCS
    phi = run_phase(tag, lambda: peel_recompute(
        tris, np.ones(g.m, bool), device=dev))
    out = dict(triangles=len(tris), rounds=rdev.SYNCS - s0 - 1)
    say(f"[8d] {out}")
    if not np.array_equal(phi.cpu().numpy().astype(np.int64), phi_want):
        raise AssertionError("8d: the global-iterate phi differs from "
                             "phase 4a's")
    return out


def perpart(bottom_up_decompose, estimate_working_set, build_graph, rmat,
            run_phase, dev) -> dict:
    """Phase 8e: the per-part seed baseline, ``bottom_up_decompose(engine=
    "perpart")``, on R-MAT scale 13 at the partition budget that
    ``truss_decompose`` derives from 5f's ``estimate_working_set // 16``;
    phi must equal the rmat13 digest, and rounds and scans the JAX
    package's."""
    n, edges = rmat(13, 8, seed=5)
    g = build_graph(n, edges)
    est = estimate_working_set(g)
    part_budget = max(64, (2 * g.m * (est // 16)) // max(est, 1))
    res = run_phase("8e per-part bottom-up rmat13", lambda: bottom_up_decompose(
        n, edges, part_budget, engine="perpart", device=dev))
    got = dict(part_budget=part_budget, rounds=res.rounds, scans=res.scans)
    say(f"[8e] {got}; parts {res.stats.parts}, largest NS "
        f"{res.stats.max_part_edges} edges, levels {len(res.candidate_sizes)}")
    check_digest("rmat13", res.phi)
    if got != MAINT_DIGESTS["8e"]:
        raise AssertionError(f"8e: {got}, the JAX package's "
                             f"{MAINT_DIGESTS['8e']}")
    return got


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
    from repro_torch.checkpoint import manager as ckpt
    from repro_torch.core import faults, serial
    from repro_torch.core.graph import (build_graph, canonical_edges,
                                        clustering_coefficient,
                                        incident_vertices)
    from repro_torch.core.kcore import cmax_core, core_decompose
    from repro_torch.core.maintain import truss_maintain
    from repro_torch.core.peel import (estimate_working_set, peel_recompute,
                                       truss_decompose)
    from repro_torch.core.bottom_up import bottom_up_decompose
    from repro_torch.core.store import ChunkedDiskStore
    from repro_torch.core.support import edge_support, list_triangles
    from repro_torch.core.top_down import top_down_decompose
    from repro_torch.data.graphgen import erdos_renyi, rmat
    from repro_torch.kernels import build
    from repro_torch.kernels.frontier_peel import kernel as fk
    from repro_torch.kernels.frontier_peel import ref as fref
    from repro_torch.kernels.triangle_count import kernel as tk
    from repro_torch.kernels.triangle_count import ref as tref
    from repro_torch.kernels.flash_attention import kernel as ak
    from repro_torch.kernels.flash_attention import ref as aref
    from repro_torch.kernels.embedding_bag import kernel as bk
    from repro_torch.kernels.embedding_bag import ref as bref
    from repro_torch.configs import registry
    from repro_torch.launch import serve
    from repro_torch.models import transformer as lm
    import torch.nn.functional as F

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
    b3_tc = b3_build_check(torch, build, ak)
    b1b2 = b1b2_build_check(build)
    b4_build = b4_build_check(build)

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

    # the last two: a lane's state past shared memory (E > 819,200, the
    # global bit planes), and more lanes than the card has SMs (a block
    # serves several lanes)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    if 160 <= sms:
        raise AssertionError(f"{sms} SMs: B = 160 no longer exceeds the grid")
    for B, E, T in ((1, 4096, 1 << 14), (8, 4096, 1 << 16),
                    (1, 65536, 1 << 20), (8, 65536, 1 << 20),
                    (1, 1 << 20, 1 << 24), (160, 4096, 1 << 14)):
        args = b1_inputs(B, E, T)
        got, want = fk.fused_round(*args), fref.fused_round(*args)
        torch.cuda.synchronize()
        for g_, w_ in zip(got, want):
            if not torch.equal(g_, w_):
                raise AssertionError(f"B1 fused_round differs from its plain "
                                     f"version at B={B} E={E} T={T}")
        # the live-row round over every row, then over fewer rows than the
        # buffer holds (lane 0 fewer again)
        for n in (T, T // 3):
            n_rows = torch.full((B,), n, dtype=torch.int32, device=dev)
            n_rows[0] = n - 5
            rw = check_b1_live(torch, fk, fref, args, n_rows,
                               f"at B={B} E={E} T={T} n_rows {n}")
            t_out, n_out = torch.empty_like(args[3]), torch.empty_like(n_rows)
            ms = time_ms(torch, lambda: fk.fused_round_live(
                *args, n_rows, t_out, n_out), 20)
            plain = time_ms(torch, lambda: fref.fused_round_live(
                *args, n_rows), 5)
            say(f"[2] B1 fused_round_live B={B} E={E} T={T} n_rows {n}: "
                f"equal (rows read {rw['rows_read']}, written "
                f"{rw['rows_written']}); kernel {ms:.4f} ms, plain "
                f"{plain:.4f} ms, bound "
                f"{b1_bound_ms(B, E, rw['rows_read'], rw['rows_written']):.4f}"
                f" ms (bytes)")
        del args, got, want, t_out

    for n in (256, 1000, 2048, 4096):
        A = (torch.rand((n, n), generator=gen, device=dev) < 0.15).to(
            torch.uint8)
        A = torch.triu(A, 1)
        A = A + A.T
        want = tref.support_dense(A)
        for sym in (True, False):       # the path passes symmetric=True
            got = tk.triangle_count(A, symmetric=sym)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                raise AssertionError(f"B2 triangle_count differs from its "
                                     f"plain version at n={n} symmetric "
                                     f"{sym}")
        Af = A.float()
        ms = time_ms(torch, lambda: tk.triangle_count(A, symmetric=True), 20)
        general = time_ms(torch, lambda: tk.triangle_count(A), 20)
        plain = time_ms(torch, lambda: tref.support_dense(A), 10)
        lib = time_ms(torch, lambda: torch.matmul(Af, Af).mul_(Af), 10)
        bound, by = b2_bound(n)
        say(f"[2] B2 triangle_count n={n}: equal (symmetric and general); "
            f"kernel {ms:.4f} ms (with the A^T copy of symmetric=False "
            f"{general:.4f} ms), plain {plain:.4f} ms, matmul+mask "
            f"{lib:.4f} ms, bound {bound:.4f} ms ({by})")
        del A, Af, got, want
    for n in (1000, 2048):      # not symmetric, with a diagonal
        A = (torch.rand((n, n), generator=gen, device=dev) < 0.3).to(
            torch.uint8)
        got, want = tk.triangle_count(A), tref.support_dense(A)
        torch.cuda.synchronize()
        if not torch.equal(got, want):
            raise AssertionError(f"B2 triangle_count differs from its plain "
                                 f"version on a non-symmetric A, n={n}")
        say(f"[2] B2 triangle_count non-symmetric n={n}: equal")
        del A, got, want

    def sdpa(q, k, v, window):
        """The library yardstick for B3: one scaled_dot_product_attention
        call (a boolean mask for the window)."""
        S = q.shape[2]
        mask = None
        if window is not None:
            i = torch.arange(S, device=q.device)
            mask = (i[None, :] <= i[:, None]) & (i[None, :] > i[:, None]
                                                 - window)
        return F.scaled_dot_product_attention(
            q, k, v, attn_mask=mask, is_causal=mask is None, enable_gqa=True)

    def check_b3(q, k, v, window, causal=True):
        tol = B3_F32_TOL if q.dtype == torch.float32 else B3_TOL
        got = ak.flash_attention(q, k, v, causal=causal, window=window)
        want = aref.mha_reference(q, k, v, causal=causal, window=window)
        torch.cuda.synchronize()
        err = float((got.float() - want.float()).abs().max())
        if not torch.allclose(got.float(), want.float(), **tol):
            raise AssertionError(f"B3 flash_attention differs from its plain "
                                 f"version at {tuple(q.shape)} Hkv "
                                 f"{k.shape[1]} {q.dtype} window {window} "
                                 f"causal {causal}: max abs err {err}")
        return err

    for B, Hq, Hkv, S, D, window, causal in B3_CASES:
        q = torch.randn((B, Hq, S, D), generator=gen, device=dev)
        k = torch.randn((B, Hkv, S, D), generator=gen, device=dev)
        v = torch.randn((B, Hkv, S, D), generator=gen, device=dev)
        errs = [check_b3(q.to(dt), k.to(dt), v.to(dt), window, causal)
                for dt in (torch.float32, torch.bfloat16)]
        say(f"[2] B3 flash_attention (B,Hq,Hkv,S,D)={(B, Hq, Hkv, S, D)} "
            f"window {window} causal {causal}: max abs err float32 "
            f"{errs[0]:.3g} (tol {B3_F32_TOL}), bf16 {errs[1]:.3g}")

    dt = torch.bfloat16
    for B in (1, 8):
        q = torch.randn((B, 8, 2048, 256), generator=gen, device=dev).to(dt)
        k = torch.randn((B, 4, 2048, 256), generator=gen, device=dev).to(dt)
        v = torch.randn((B, 4, 2048, 256), generator=gen, device=dev).to(dt)
        for window in (None, 1024):
            err = check_b3(q, k, v, window)
            ms = time_ms(torch, lambda: ak.flash_attention(
                q, k, v, window=window), 5)
            plain = time_ms(torch, lambda: aref.mha_reference(
                q, k, v, window=window), 3)
            lib = time_ms(torch, lambda: sdpa(q, k, v, window), 5)
            bound, by = b3_bound(q, k, window)
            say(f"[2] B3 flash_attention (B,Hq,S,D)={tuple(q.shape)} Hkv "
                f"{k.shape[1]} bf16 window {window}: max abs err {err:.3g} "
                f"(tol {B3_TOL}); kernel {ms:.4f} ms (run E "
                f"{B3_RUN_E_MS[B, window]:.4f} ms), plain {plain:.4f} ms, "
                f"sdpa {lib:.4f} ms, bound {bound:.4f} ms ({by})")
        del q, k, v

    b4 = b4_phase(torch, F, bk, bref, gen, b4_build, dev)

    # -- truss path: phases 3-5 ----------------------------------------------
    kernel_mods = {"B1": fk, "B2": tk, "B3": ak, "B4": bk}

    def zero_counts():
        for mod in kernel_mods.values():
            mod.LAUNCHES = 0

    zero_counts()
    # B1's bound counts the rows each call reads and writes, known on the
    # device only: the counts are summed after each call, read at the end
    p1 = b1_probe(torch, fk)
    p2 = Probe(torch, tk, "triangle_count", size=lambda A, **kw: A.numel(),
               bound=lambda A, **kw: b2_bound(A.shape[0])[0])
    phase_launches = {}
    phase_walls = {}
    trace_ms: dict = {}        # --profile: device ms and calls by kernel name
    phase_trace: dict = {}     # --profile: the same, by phase

    def run_phase(tag, fn):
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        # held when the phase starts (the probes keep earlier phases' inputs)
        mem0 = torch.cuda.memory_allocated()
        l0 = {n: mod.LAUNCHES for n, mod in kernel_mods.items()}
        s0 = rdev.SYNCS
        prof = None
        if profile:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CUDA])
            prof.__enter__()
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = {n: mod.LAUNCHES - l0[n] for n, mod in kernel_mods.items()}
        phase_launches[tag] = launches
        phase_walls[tag] = wall
        say(f"[{tag}] wall {wall:.3f} s, host syncs {rdev.SYNCS - s0}, "
            f"launches {launches}, peak device memory "
            f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ("
            f"{mem0 / 2**20:.1f} MiB held at its start)")
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
            phase_trace[tag] = per_name
            for name, (ns, cnt) in per_name.items():
                ms0, cnt0 = trace_ms.get(name, (0.0, 0))
                trace_ms[name] = (ms0 + ns / 1e6, cnt0 + cnt)
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
    if phase_launches["4 bottom-up rmat15"]["B1"] == 0:
        raise AssertionError("bottom-up never launched the B1 kernel")
    # phase 4b: phase 4's call with the locality partitioner
    phi15_loc, lst = run_phase("4b locality bottom-up rmat15",
                               lambda: truss_decompose(
                                   n15, e15, engine="bottom-up",
                                   memory_budget=budget,
                                   partitioner="locality", with_stats=True,
                                   device=dev))
    say(f"[4b] rounds {lst.rounds} (sequential, phase 4: {ost.rounds}), "
        f"tri_locality {lst.tri_locality:.4f} ({ost.tri_locality:.4f}); "
        f"stage-1 batch building {lst.round_build_s:.3f} s "
        f"({ost.round_build_s:.3f} s), device peels {lst.peel_s:.3f} s "
        f"({ost.peel_s:.3f} s), candidates {lst.candidate_build_s:.3f} s; "
        f"OocStats {lst}")
    if not np.array_equal(phi15_loc, phi15):
        raise AssertionError("4b: the locality bottom-up phi differs")
    if phase_launches["4b locality bottom-up rmat15"]["B1"] == 0:
        raise AssertionError("4b never launched the B1 kernel")
    # phase 4c: phase 4's call with the working graph in a disk store
    graph_bytes, host_budget, chunk_bytes = store_budget(g15)
    with tempfile.TemporaryDirectory(prefix="chip_smoke_store_") as sd, \
            ChunkedDiskStore(sd, host_memory_budget=host_budget,
                             chunk_bytes=chunk_bytes) as store:
        phi15_disk, dst = run_phase("4c disk-store bottom-up rmat15",
                                    lambda: truss_decompose(
                                        n15, e15, engine="bottom-up",
                                        memory_budget=budget, store=store,
                                        with_stats=True, device=dev))
        peak = store.stats.peak_resident_bytes
    disk = dict(graph_bytes=graph_bytes, host_memory_budget=host_budget,
                chunk_bytes=chunk_bytes, **io_row(dst, peak))
    wall4, wall4c = (phase_walls["4 bottom-up rmat15"],
                     phase_walls["4c disk-store bottom-up rmat15"])
    say(f"[4c] {disk}; wall {wall4c:.3f} s against phase 4's {wall4:.3f} s "
        f"(slowdown {wall4c / wall4:.3f}); stage-1 batch building "
        f"{dst.round_build_s:.3f} s, device peels {dst.peel_s:.3f} s")
    if not np.array_equal(phi15_disk, phi15):
        raise AssertionError("4c: the disk-store bottom-up phi differs")
    if not (dst.bytes_spilled > 0 and dst.chunk_reads > 0
            and peak <= host_budget and dst.prefetch_hit_rate >= 0.5):
        raise AssertionError(f"4c: spilled {dst.bytes_spilled} bytes, read "
                             f"{dst.chunk_reads} chunks, peak {peak} of "
                             f"{host_budget}, hit rate "
                             f"{dst.prefetch_hit_rate:.4f} (>= 0.5 wanted)")
    if phase_launches["4c disk-store bottom-up rmat15"]["B1"] == 0:
        raise AssertionError("4c never launched the B1 kernel")

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
    if phase_launches["5c top-down er2048"]["B2"] == 0:
        raise AssertionError("top-down never launched the B2 kernel on the "
                             "dense core")
    # phase 5d: budgeted top-down on rmat15, at phase 4's memory_budget
    phi15_td, tdst = run_phase("5d budgeted top-down rmat15",
                               lambda: truss_decompose(
                                   n15, e15, engine="top-down",
                                   memory_budget=budget, with_stats=True,
                                   device=dev))
    say(f"[5d] memory_budget {budget} entries; OocStats rounds "
        f"{tdst.rounds}, tri_total {tdst.tri_total}, tri_assigned "
        f"{tdst.tri_assigned}, retries {tdst.retries}; stage-1 batch "
        f"building {tdst.round_build_s:.3f} s, level candidates "
        f"{tdst.candidate_build_s:.3f} s, level peels {tdst.peel_s:.3f} s; "
        f"{tdst}")
    if not np.array_equal(phi15_td, phi15):
        raise AssertionError("budgeted top-down phi differs on rmat15")
    if tdst.retries or phase_launches["5d budgeted top-down rmat15"][
            "B1"] == 0:
        raise AssertionError("budgeted top-down retried or never launched "
                             "the B1 kernel")
    launches = {"frontier_peel": fk.LAUNCHES, "triangle_count": tk.LAUNCHES}
    if ak.LAUNCHES or bk.LAUNCHES:
        raise AssertionError("the truss path launched B3 or B4")
    total_ms = {"frontier_peel": p1.close(), "triangle_count": p2.close()}
    for name, count in launches.items():
        if count == 0:
            raise AssertionError(f"kernel {name} never launched on the truss "
                                 f"path")
    if (len(p1.events), len(p2.events)) != tuple(launches.values()):
        raise AssertionError("launch counters disagree with the calls seen")
    # rows each B1 call read and wrote, and the padded capacity (pow4 of its
    # buffer) that the sweep of every row before the live-row design read
    b1_path = b1_rows(torch, p1)
    say(f"[truss path] launches {launches}, device ms between each call's "
        f"events (host gaps included) "
        f"{ {k: round(v, 3) for k, v in total_ms.items()} }, summed bounds "
        f"B1 {b1_path['bound_ms']:.3f} ms B2 {p2.bound_ms:.3f} ms")
    say(f"[truss path] B1 rows read {b1_path['rows_read']:,}, written "
        f"{b1_path['rows_written']:,}; the padded capacities of the same "
        f"calls {b1_path['padded_rows']:,}")
    say(f"[truss path] B1 launches by phase: "
        f"{ {t: c['B1'] for t, c in phase_launches.items()} }")
    say(f"[truss path] B1 launch shapes (count): "
        f"{sorted(p1.shapes.items(), key=lambda kv: -kv[1])[:8]}")
    trace_total = {}
    if profile:
        for key, want_name in (("frontier_peel", B1_TRACE_NAME),
                               ("triangle_count", B2_TRACE_NAME)):
            names = {nm: v for nm, v in trace_ms.items() if want_name in nm}
            say(f"[truss path] profiler: {key} kernels "
                f"{ {nm[:60]: (round(v[0], 3), v[1]) for nm, v in names.items()} }")
            if len(names) != 1:
                raise AssertionError(f"the trace holds {len(names)} kernel "
                                     f"names of {key}, not one")
            (ms_, cnt_), = names.values()
            if cnt_ != launches[key]:
                raise AssertionError(f"the trace holds {cnt_} {key} kernels, "
                                     f"the counter {launches[key]}")
            trace_total[key] = ms_

    # -- phases 5e, 5f: kill and resume, the retry ladder ------------------
    resilience = dict(kill_and_resume=kill_and_resume(
        truss_decompose, ckpt, run_phase, n15, e15, budget, phi15, dev))

    def check_b1(where):
        args = b1_inputs(4, 4096, 1 << 14)
        n_rows = torch.full((4,), 1 << 13, dtype=torch.int32, device=dev)
        check_b1_live(torch, fk, fref, args, n_rows, where)

    resilience["retry_ladder"] = retry_ladder(
        torch, faults, truss_decompose, estimate_working_set, build_graph,
        rmat, check_b1, dev)

    # -- phases 5g, 5h: the disk store under top-down, a kill mid-spill -----
    resilience["store"] = dict(rmat15_4c=disk, **store_phases(
        truss_decompose, estimate_working_set, build_graph, rmat,
        ChunkedDiskStore, ckpt, run_phase, phase_launches, dev))

    # -- phases 8a-8e: maintenance, Table 6, the two baselines ---------------
    pm = b1_probe(torch, fk)
    maint = dict(edit_stream=edit_stream(
        truss_maintain, truss_decompose, run_phase, phase_walls,
        phase_launches, n15, e15, phi15, dev))
    maint_host_ms = pm.close()
    maint_tags = [t for t in phase_launches if t.startswith("8a maintain")]
    maint_launches = sum(phase_launches[t]["B1"] for t in maint_tags)
    if len(pm.events) != maint_launches:
        raise AssertionError("8a: launch counters disagree with the calls "
                             "seen")
    maint_rows = b1_rows(torch, pm)
    (sup, alive, rm, tris, n_rows), _ = pm.largest[None]
    args = (sup, alive, rm, tris)
    B, E, T = sup.shape[0], sup.shape[1], tris.shape[1]
    rw = check_b1_live(torch, fk, fref, args, n_rows,
                       f"on 8a's largest call (B={B} E={E} T={T})")
    t_out, n_out = torch.empty_like(tris), torch.empty_like(n_rows)
    b1_maint = dict(
        launches=maint_launches, shape=[B, E, T],
        max_abs_err=rw.pop("max_abs_err"),
        ms=time_ms(torch, lambda: fk.fused_round_live(
            *args, n_rows, t_out, n_out), 50),
        plain_ms=time_ms(torch, lambda: fref.fused_round_live(
            *args, n_rows), 20),
        bound_ms=b1_bound_ms(B, E, rw["rows_read"], rw["rows_written"]),
        **rw, total_host_inclusive_ms=maint_host_ms,
        total_bound_ms=maint_rows["bound_ms"],
        path_rows_read=maint_rows["rows_read"],
        path_rows_written=maint_rows["rows_written"],
        launch_shapes=sorted(pm.shapes.items(), key=lambda kv: -kv[1])[:4])
    if profile:
        b1_maint["total_ms"] = sum(
            ns / 1e6 for t in maint_tags
            for nm, (ns, _) in phase_trace[t].items() if B1_TRACE_NAME in nm)
    say(f"[8a] B1 over the maintenance: {b1_maint}")
    del sup, alive, rm, tris, args, t_out, pm
    maint["kill_and_resume"] = maintain_kill_and_resume(
        truss_maintain, truss_decompose, build_graph, rmat, ChunkedDiskStore,
        faults, ckpt, run_phase, phase_launches, dev)
    maint["table6"] = table6(core_decompose, cmax_core,
                             clustering_coefficient, incident_vertices,
                             canonical_edges, run_phase, n17, e17, phi17, dev)
    maint["global_iterate"] = global_iterate(peel_recompute, list_triangles,
                                             run_phase, rdev, g15, phi15, dev)
    maint["perpart"] = perpart(bottom_up_decompose, estimate_working_set,
                               build_graph, rmat, run_phase, dev)
    if any(c[k] for t, c in phase_launches.items() if t.startswith("8")
           for k in ("B2", "B3", "B4")):
        raise AssertionError("phases 8a-8e launched B2, B3 or B4")
    say(f"[8a-8e] {json.dumps(maint)}")

    # -- phase 6: digests -----------------------------------------------------
    for name, phi in (("rmat17", phi17), ("rmat15", phi15),
                      ("rmat15", phi15_bu), ("rmat15", phi15_loc),
                      ("rmat15", phi15_disk), ("rmat15", td15.phi),
                      ("rmat15", phi15_td),
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
        "bottom-up, locality bottom-up, disk-store bottom-up, top-down, "
        "budgeted top-down) and er2048 (in-memory, top-down); Figure-2 "
        "equals alg2_truss")
    say(f"[5e-5h] {json.dumps(resilience)}")

    # -- phase 7: LM path, gemma3-4b served at full width --------------------
    cfg = dataclasses.replace(registry.get_config("gemma3-4b"),
                              use_flash_kernel=True)
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    n_params = sum(a.numel() for a in [params["embed"], params["final_norm"],
                                       *params["layers"].values()])
    if n_params != cfg.param_count():
        raise AssertionError(f"{n_params} parameters, config says "
                             f"{cfg.param_count()}")
    say(f"[7] gemma3-4b: {cfg.n_layers} layers, d_model {cfg.d_model}, vocab "
        f"{cfg.vocab}, {n_params:,} parameters in bf16, initialised on the "
        f"card in {time.perf_counter() - t0:.2f} s")
    n_req, prompt_len, new_tokens, max_seq = 8, 2048, 32, 2080
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (n_req, prompt_len)).astype(np.int32)
    p3 = Probe(torch, ak, "flash_attention",
               size=lambda q, k, v, causal, window: q.numel() *
               visible_pairs(q.shape[2], window),
               bound=lambda q, k, v, causal, window: b3_bound(q, k,
                                                              window)[0],
               group=lambda q, k, v, causal, window: window)
    zero_counts()
    gen_out = run_phase("7 serve gemma3-4b", lambda: serve.generate(
        params, prompts, cfg, new_tokens, max_seq, device=dev))
    lm_launches = {"flash_attention": ak.LAUNCHES}
    b3_ms = p3.close()
    if fk.LAUNCHES or tk.LAUNCHES or bk.LAUNCHES:
        raise AssertionError("the LM path launched B1, B2 or B4")
    if ak.LAUNCHES != cfg.n_layers or len(p3.events) != ak.LAUNCHES:
        raise AssertionError(f"B3 launched {ak.LAUNCHES} times in one "
                             f"prefill of {cfg.n_layers} layers")
    say(f"[7] {n_req} requests x {prompt_len} prompt tokens: prefill wall "
        f"{gen_out.prefill_s * 1e3:.1f} ms; {new_tokens} decode steps in "
        f"{gen_out.decode_s * 1e3:.1f} ms = "
        f"{n_req * new_tokens / gen_out.decode_s:.1f} tokens/s; B3 "
        f"{ak.LAUNCHES} launches, {b3_ms:.3f} device ms in its calls "
        f"(summed bounds {p3.bound_ms:.3f} ms); first request's tokens "
        f"{gen_out.tokens[0, :8].tolist()}...")
    flash_logits = gen_out.prefill_logits.float()
    if gen_out.tokens.shape != (n_req, new_tokens) or \
            flash_logits.shape != (n_req, cfg.vocab) or \
            not bool(torch.isfinite(flash_logits).all()):
        raise AssertionError("phase 7 output has the wrong shape or is not "
                             "finite")
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    t0 = time.perf_counter()
    _, plain_logits = lm.prefill(params, prompts, plain_cfg, max_seq=max_seq,
                                device=dev)
    plain_logits = plain_logits.float()
    torch.cuda.synchronize()
    diff = (flash_logits - plain_logits).abs()
    say(f"[7] plain-path prefill (chunked/banded attention) "
        f"{(time.perf_counter() - t0) * 1e3:.1f} ms; last-token logits: "
        f"max |plain| {float(plain_logits.abs().max()):.4f}, max |flash - "
        f"plain| {float(diff.max()):.4f}, mean {float(diff.mean()):.5f} "
        f"(tol {LOGITS_TOL})")
    if not torch.allclose(flash_logits, plain_logits, **LOGITS_TOL):
        raise AssertionError("phase 7: the flash prefill's logits differ "
                             "from the plain path's beyond the tolerance")
    # what LOGITS_TOL can see: the plain path with its window rule broken
    for label, window in (("a window off by one key", cfg.window - 1),
                          ("no window", None)):
        _, alt = lm.prefill(params, prompts, dataclasses.replace(
            plain_cfg, window=window), max_seq=max_seq, device=dev)
        d_alt = (alt.float() - plain_logits).abs()
        say(f"[7] plain path with {label}: last-token logits move by "
            f"{float(d_alt.max()):.4f} at most, mean {float(d_alt.mean()):.5f}"
            f"; within LOGITS_TOL: "
            f"{bool(torch.allclose(alt.float(), plain_logits, **LOGITS_TOL))}")
        del alt, d_alt
    del params, gen_out, flash_logits, plain_logits, diff

    # -- kernels on the largest inputs the main path gave them ---------------
    kernels = []
    (sup, alive, rm, tris, n_rows), _ = p1.largest[None]
    args = (sup, alive, rm, tris)
    B, E, T = sup.shape[0], sup.shape[1], tris.shape[1]
    rw = check_b1_live(torch, fk, fref, args, n_rows,
                       f"on the path's largest call (B={B} E={E} T={T})")
    err = rw.pop("max_abs_err")
    t_out, n_out = torch.empty_like(tris), torch.empty_like(n_rows)
    kernels.append(dict(
        name="frontier_peel.fused_round_live", route="cuda",
        source="src/repro_torch/csrc/frontier_peel.cu",
        replaces="src/repro/kernels/frontier_peel/kernel.py:115",
        launches=launches["frontier_peel"] + maint_launches,
        launches_by_path={"truss (3-5d)": launches["frontier_peel"],
                          "maintenance (8a)": maint_launches},
        max_abs_err=max(err, b1_maint["max_abs_err"]),
        ms=time_ms(torch, lambda: fk.fused_round_live(
            *args, n_rows, t_out, n_out), 20),
        plain_ms=time_ms(torch, lambda: fref.fused_round_live(
            *args, n_rows), 5),
        bound_ms=b1_bound_ms(B, E, rw["rows_read"], rw["rows_written"]),
        bound_by="bytes", library_ms=None, shape=[B, E, T], **rw,
        total_ms=trace_total.get("frontier_peel"),
        total_host_inclusive_ms=total_ms["frontier_peel"],
        total_bound_ms=b1_path["bound_ms"],
        path_rows_read=b1_path["rows_read"],
        path_rows_written=b1_path["rows_written"],
        path_padded_rows=b1_path["padded_rows"], maintenance=b1_maint,
        design=B1_DESIGN, build=b1b2["frontier_peel"]))
    say(f"[truss path] B1 on the path's largest call B={B} E={E} T={T} "
        f"n_rows {n_rows.tolist()[:4]}: equal (rows read {rw['rows_read']}, "
        f"written {rw['rows_written']}); kernel {kernels[-1]['ms']:.4f} ms, "
        f"plain {kernels[-1]['plain_ms']:.4f} ms, bound "
        f"{kernels[-1]['bound_ms']:.4f} ms (bytes)")
    del sup, alive, rm, tris, args, t_out, p1
    (A,), kw = p2.largest[None]
    got, want = tk.triangle_count(A, **kw), tref.support_dense(A)
    Af = A.float()
    bound, by = b2_bound(A.shape[0])
    kernels.append(dict(
        name="triangle_count.triangle_count", route="cuda",
        source="src/repro_torch/csrc/triangle_count.cu",
        replaces="src/repro/kernels/triangle_count/kernel.py:73",
        launches=launches["triangle_count"],
        max_abs_err=float((got - want).abs().max()),
        ms=time_ms(torch, lambda: tk.triangle_count(A, **kw), 20),
        plain_ms=time_ms(torch, lambda: tref.support_dense(A), 10),
        bound_ms=bound, bound_by=by,
        library_ms=time_ms(torch, lambda: torch.matmul(Af, Af).mul_(Af), 10),
        shape=[A.shape[0]], symmetric=kw.get("symmetric", False),
        # what symmetric=True saves on this call: the general route's A^T
        # copy alone, and the wrapper's time with it
        transpose_ms=time_ms(torch, lambda: A.t().contiguous(), 20),
        general_ms=time_ms(torch, lambda: tk.triangle_count(A), 20),
        total_ms=trace_total.get("triangle_count"),
        total_host_inclusive_ms=total_ms["triangle_count"],
        total_bound_ms=p2.bound_ms, design=B2_DESIGN,
        build=b1b2["triangle_count"]))
    if kernels[-1]["max_abs_err"] != 0:
        raise AssertionError("B2 differs from its plain version on the main "
                             "path's input")
    say(f"[truss path] B2 on the path's call n={A.shape[0]} {kw}: equal; "
        f"kernel {kernels[-1]['ms']:.4f} ms (symmetric=False: "
        f"{kernels[-1]['general_ms']:.4f} ms, its A^T copy "
        f"{kernels[-1]['transpose_ms']:.4f} ms), plain "
        f"{kernels[-1]['plain_ms']:.4f} ms, matmul+mask "
        f"{kernels[-1]['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
    del A, Af, got, want
    # B3: the largest global and the largest windowed call, on the path's
    # own strided (B, S, H, D) views, in bf16 and (upcast, strides kept) in
    # float32; the line keeps the largest of them
    b3_rows = []
    for window, ((q, k, v), kw) in sorted(
            p3.largest.items(), key=lambda kv: kv[0] or 0):
        err32 = check_b3(q.float(), k.float(), v.float(), window)
        bound, by = b3_bound(q, k, window)
        row = dict(
            name="flash_attention.flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:101",
            launches=lm_launches["flash_attention"],
            max_abs_err=check_b3(q, k, v, window),
            ms=time_ms(torch, lambda: ak.flash_attention(
                q, k, v, window=window), 5),
            plain_ms=time_ms(torch, lambda: aref.mha_reference(
                q, k, v, window=window), 3),
            bound_ms=bound, bound_by=by,
            library_ms=time_ms(torch, lambda: sdpa(q, k, v, window), 5),
            shape=[*q.shape, k.shape[1]], strides=list(q.stride()),
            window=window, float32_err=err32)
        kind = "global" if window is None else "windowed"
        say(f"[7] B3 on the path's largest {kind} call {row['shape']} "
            f"window {window} strides {row['strides']}: "
            f"max abs err bf16 {row['max_abs_err']:.3g}, float32 "
            f"{err32:.3g}; kernel {row['ms']:.4f} ms, plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {bound:.4f} ms ({by})")
        b3_rows.append(row)
    by_window = [{k: r[k] for k in ("window", "max_abs_err", "float32_err",
                                    "ms", "plain_ms", "library_ms",
                                    "bound_ms")} for r in b3_rows]
    b3 = max(b3_rows, key=lambda r: r["bound_ms"])
    b3.update(max_abs_err=max(r["max_abs_err"] for r in b3_rows),
              total_ms=b3_ms, total_bound_ms=p3.bound_ms,
              by_window=by_window, design=B3_DESIGN, bf16_d256=b3_tc)
    kernels.append(b3)
    kernels.append(b4)
    say(f"[all] wall {time.perf_counter() - t_all:.1f} s; {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
