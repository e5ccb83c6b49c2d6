"""Smoke run of the PyTorch/CUDA port (``src/repro_torch``) on one NVIDIA card.

Run from the repository root, with no arguments:

    python3 chip_smoke.py

Phases (each prints its timings; any mismatch raises and exits non-zero):

1. device: the card's name and power limit, torch and CUDA versions, and the
   build of every CUDA kernel under ``src/repro_torch/csrc`` (one ``nvcc``
   per source, all started together); for every B3 instantiation, its
   registers, spills and shared memory (ptxas) and its tensor-core
   instructions (``cuobjdump -sass``): the bf16 D = 256 (gemma3-4b) and D =
   128 (the MoE configs) ones must have some and spill nothing; the same for B1 and B2, whose SASS must hold int8 MMA
   instructions (B2) and neither of which may spill; and the registers,
   spills and static shared memory of every B4 instantiation and of its
   gather probe, none of which may spill; and every B5 instantiation's
   (decode attention: the kernel by dtype and group bucket, its combine),
   none of which may spill or hold a tensor-core instruction, the kernel's
   each holding cp.async (LDGSTS) instructions;
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
   segments would move; B5 decode attention on ``B5_CASES`` in float32
   and bf16 (``B5_F32_TOL``, ``B5_TOL``; every position a row cannot see
   set to NaN for the kernel and 0 for the plain version, so a hidden
   position read shows), then timed at ``B5_TIMED``, the DeepSeekMoE-16B
   b160 cell's layer shape and gemma3-4b's local and global layers, beside
   the plain version, masked SDPA and the byte bound;
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
   5c. on the dense core whose S B2 computed (the whole er2048 graph):
       ``ref.triangle_total(S)`` must equal the rows of the host triangle
       list (``list_triangles_np``) and ``ref.edge_support(S, edges)`` at
       the core's canonical edges ``edge_support_np``, both exactly (the
       two host oracles run in a child process started after phase 1, at
       nice 19 beside phases 2-5c, ``DENSE_ORACLE_CHILD``);
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
       ``benchmarks/run.py``'s ``table5maint``) and of ``closing_insert``'s
       one insertion that closes 29 triangles, each followed by a
       recompute of the maintained edges on the card; phi equal to the
       recompute and to the digest, B1 launched at b = 64 and by the
       closing insertion (whose region must be non-empty), and
       ``speedup_vs_recompute`` at least 5 at b = 1 (the reference's gate;
       that edit closes no triangle, so it times the splice);
       B1 is then checked and timed on the largest call the maintenance
       gave it;
   8b. 16 edits on 5f's graph through a disk store in 5h's regime,
       journaled every edit: phi and the write counters equal the JAX
       package's; a child process (importing only ``repro_torch``) running
       the same call is SIGKILLed before edit 4 and resumed here on the
       same journal: the same phi, ``resumed_round`` 3, edits 4-15 alone
       replayed, B1 launched by the replay of deletions 4-7;
   8c. Table 6 on phase 3's graph: core numbers and the c_max-core on the
       card, the k_max-truss from phase 3's phi, and V, E, k and the
       clustering coefficients of both, equal to the JAX package's;
   8d. the global-iterate peel (``peel_recompute``) on phase 4's triangle
       list: phi equal to phase 4a's;
   8e. the per-part seed baseline, ``bottom_up_decompose(engine=
       "perpart")``, on 5f's graph: phi equal to the rmat13 digest, rounds
       and scans equal to the JAX package's;
9. after 8e: the mesh paths (``core.distributed`` on ``torch.distributed``),
   each through ``run_phase``:
   9a. a one-rank NCCL process group in this process (a ``HashStore``, no
       network) and ``DeviceMesh``es of shape (1,) and (1, 1): phase 4's
       bottom-up call with ``mesh=``, phi equal to phase 4a's and the
       digest, ``OocStats.devices`` 1, ``sharded_rounds`` above 0, B1
       launched; budgeted top-down on 5f's graph with ``mesh_axes=("data",
       "tri")``, phi equal to the rmat13 digest; 8a's 64 edits with the
       mesh, equal to 8a's digest; B1 is then checked and timed on the
       largest call the mesh path gave it;
   9b. two child processes (``sys.executable``, importing only
       ``repro_torch``), one gloo group on the one card (NCCL refuses two
       ranks on one GPU): on 5f's graph, bottom-up with a ("data",) mesh of
       2, budgeted top-down on a (1, 2) ("data", "tri") mesh,
       ``peel_classes_sharded`` on the padded triangle list, and bottom-up
       under ``MESH_DROP_RULE`` (the dispatch and both lane splits fail, so
       the ladder drops the mesh); every phi equal to the rmat13 digest on
       both ranks, ``devices`` 2, B1 launched on each rank, ``degraded``
       at least 1, the ranks' counters equal; a rank that does not finish
       within the timeout is killed and fails the phase;
   9c. ``ring_support_dense`` and ``allgather_support_dense`` on 5b's ER
       core at 9a's one rank, and on an ER core of 512 vertices at 9b's two:
       S equal to B2's S on every edge, zero off them;  the collective
       calls (``distributed.COLLECTIVES``) are printed and must be positive;
6. phi of every graph of phases 3-5 (4b, 4c and 5d included) against
   digests of the JAX package's answer, and the paper's Figure-2 graph
   against the port's serial oracle; then the paper's Algorithm 1
   (``serial.alg1_truss``) on the Figure-2 graph and on 5f's graph (R-MAT
   scale 13), equal to the rmat13 digest and to ``alg2_truss``, with one
   line of both host walls beside the in-memory ``truss_decompose`` wall on
   the card for that graph (the paper's Table 3 in miniature; it gates
   nothing); ``truss_from_phi`` at k_max on phase 3's graph equal, as a
   set, to 8c's k_max-truss, and on rmat13 to ``kmax_truss`` on the card;
7. LM serving: gemma3-4b at full width (34 layers, d_model 2560, vocab
   262,144, bf16, random weights from a generator seeded with 0, the flash
   kernel on) serves 8 requests of 2,048-token prompts and 32 greedy decode
   steps through ``serve.generate``; B3 must launch once per layer, B5 once
   per layer and decode step (twice where its split plan splits), the
   logits must be finite, and the prefill's last-token logits must agree
   with the plain attention path's within ``LOGITS_TOL``.  It also prints
   how far the plain path's logits move with a window off by one key and
   with no window at all, as a measure of what that limit can see;
   7b. MoE serving: moonshot-v1-16b-a3b at full width (all 48 layers,
       d_model 2048, 16/16 heads of 128, 64 experts of 1,408, top 6 plus 2
       shared, vocab 163,840; 28,888,467,456 parameters in bf16, the router
       float32; random weights from a generator seeded with 0, the flash
       kernel on) serves phase 7's traffic through ``serve.generate``, after
       phase 7's parameters are freed: the parameter count must be
       ``param_count()``, B3 must launch once per layer (48), B5 as in
       phase 7, and nothing else, the logits must be finite.  It prints the init time, prefill
       wall, decode tokens/s beside a step's byte bound, the peak device
       memory and the share of slots dropped per layer (min, median, max)
       in the prefill and in the decode steps (``RouteRecorder`` wraps the
       routing helper, ``moe_route``).  Then two prefills on the plain
       attention path, one routing on its own values and one replaying the
       flash prefill's routing: it prints the kept slots whose routing
       differs per layer and the requests whose routing differs, and holds
       the last-token logits to the flash prefill's within MOE_LOGITS_TOL on
       the requests routed alike in every layer and, with the routing
       replayed, on every request;
   7c. the same for phi3.5-moe-42b-a6.6b at its full widths (d_model 4096,
       32/8 heads of 128, 16 experts of 6,400, top 2, no shared expert,
       vocab 32,064) with its depth cut from 32 to 8 layers (its 78.0 GiB of
       bf16 parameters do not fit one card beside a cache): B3 8 launches,
       group 4;
   7d. one full-width MoE layer, card against host: ``_moe_ffn`` with 7b's
       layer-0 FFN weights on MOE_ROWS rows of that layer's actual input
       (bf16) on the card and on the CPU; the experts, slots and kept flags
       equal (a token whose router margin is below ROUTE_EPS excused), the
       outputs within MOE_FFN_TOL, aux within MOE_AUX_TOL;
10. after 7d, once every LM parameter of phases 7-7d is freed: training,
    each part through ``run_phase``:
    10a. every LM arch at ``reduced_lm`` in float32, from the same host
         parameters and TokenStream batch: ``loss_fn``'s loss, aux and every
         gradient, and one ``make_train_step(microbatches=2)`` step, on the
         card against the same calls on the host (``TRAIN_TOL``, the
         parameters at ``TRAIN_STEP_TOL``); then ``train_loop.run`` on
         qwen2.5-14b's reduced config for 40 steps at lr 1e-3, whose loss
         must fall (the mean of the last 5 below the first), and the same
         run with a ``fault_hook`` raising ``RuntimeError`` at step 17, which
         restores step 10's checkpoint and must replay to the same losses;
    10b. one gemma3-4b global layer (layer 5) at full width, ``x + attn +
         ffn`` on 512 tokens in float32: the gradients of every layer weight
         and of x on the card against the host, within LAYER_GRAD_RTOL;
    10c. gemma3-4b trained at full width (all 34 layers, d_model 2,560,
         vocab 262,144, bf16, remat "full", random weights from a generator
         seeded with 0): three ``make_train_step`` steps on one TokenStream
         sequence of 4,096 tokens, the same batch each step, AdamW at lr
         1e-3 after one warmup step.  The loss and grad_norm must be finite,
         the loss must fall from step 0 to step 2, no kernel may launch (B3
         has no backward, as the reference's Pallas kernel has no reverse
         mode), ``loss_fn`` with ``use_flash_kernel=True`` under a gradient
         must raise, and AdamW's own peak may be at most two float32 copies
         of the largest leaf.  It prints the init time, and per step the
         wall, the forward-and-backward and AdamW shares, tokens/s, the peak
         device memory and ``train_mfu``: 6 x ``param_count()`` x tokens plus
         3 x the attention's forward flops (the port's
         ``lm_family._attn_fwd_flops``; remat's recompute not counted) over
         the wall and 989 TFLOP/s, beside that flop bound.

11. after phase 10: DIN at full width (``configs/din.py``: 10,000,000 items
    and 1,000 categories, embed 18, seq 100, attention MLP 80-40, head
    200-80; 180,054,282 parameters, random weights from a generator seeded
    with 0 on the card; batches from ``RecsysStream(seed=0)``), each part
    through ``run_phase``; its lookups go through B4 (bags of one row, sum):
    11a. ``serve_p99`` (B = 512): ``din_scores`` on the card (B4, 4
         launches) against the same call on the host (the take) within
         DIN_TOL, and equal to the card's take route exactly; warm walls;
    11b. ``serve_bulk`` (B = 262,144): both routes on the card, scores
         equal exactly, walls and peaks; B4's four calls probed, each
         checked against its plain version and timed beside its bound and
         ``torch.index_select`` on the same ids;
    11c. ``retrieval_cand``: 1 user x 1,000,000 candidates in 50 chunks (B4
         102 launches), 512 candidates' scores against ``din_scores`` of
         the same pairs within DIN_RETRIEVAL_TOL;
    11e. ``sharded_lookup`` on a one-rank NCCL mesh ("model",): equal to
         the take, one collective;
    11d. ``train_batch`` (B = 65,536): DIN_TRAIN_STEPS steps of
         ``make_train_step(din_loss)`` with AdamW at the family's OCFG (the
         take route): losses finite, no B4 launch, ``kernel="bag"`` under a
         gradient raising; step walls, AdamW share, peak;
12. the GNNs (``configs/gnn_family.py``'s shapes), each through
    ``run_phase``:
    12a. each GNN arch at ``reduced_gnn`` and DIN at ``reduced_din``: loss
         and every gradient on the card against the host (GNN_TOL,
         GNN_GRAD_RTOL);
    12b. one EquiformerV2 block at full width (C = 128, l_max 6, m_max 2,
         8 heads) on 2,048 molecule edges, float32, card against host
         within EQV2_GRAD_RTOL; the rotation-invariance check on the card;
    12c. GNN_TRAIN_STEPS training steps each (``make_train_step``, the
         family's OCFG): gat-cora on a Cora-sized graph (2,708 nodes, 1,433
         features, 21,112 directed edges); GraphSAGE on ``minibatch_lg``
         (1,024 seeds, fanouts 15-10: 169,984 nodes x 602 features,
         168,960 edges) sampled uniformly from an Erdos-Renyi graph with
         Reddit's 232,965 nodes and REDDIT_EDGES edges, and by trussness
         from phase 4's graph (``sparsify.sampling_weights``, phi on the
         card, held to phase 4a's); MeshGraphNet (15 layers) on the uniform
         batch's subtree; EquiformerV2 (12 layers) on 128 molecules
         (3,840 nodes, 16,384 edges, 8 edge chunks).  Losses finite, no
         kernel launched; step walls, nodes/s, gnn_family's flops over the
         wall against FP32_FLOPS_PER_S, AdamW share, peak.
13. the cell and dry-run layer, each part through ``run_phase``:
    13a. ``python -m repro_torch.launch.dryrun --all --jobs DRYRUN_JOBS``:
         every cell of the registry traced on pod16x16 (a fake 256-rank
         group, no card) by a child process started after phase 1 that
         runs beside phases 2-12 at the lowest CPU priority (nice 19, so
         those phases keep their host); the smoke waits at most
         DRYRUN_WAIT_S for it.  Every record must be ok;
         ``report.render``'s table, the bottleneck counts, each cell's
         trace seconds and the cells whose per-device arg + temp bytes fit
         80 GiB are printed;
    13b. CELL_RUNS (the cells whose whole inputs fit one card) built on a
         one-rank NCCL (1, 1) mesh, their args made on the card from a
         generator seeded with 0 (ids in range, masks 0/1), run once: the
         args' bytes equal the (1, 1) dry run's arg_bytes exactly, the
         card's peak less what was held before the step is within
         TEMP_FACTOR of its temp_bytes (both raised to TEMP_FLOOR), the
         outputs are finite, B4 launches CELL_B4 times on DIN's serve and
         retrieval cells and nothing launches elsewhere; walls and
         model_flops over the wall (mfu);
    13c. both ring losses (``models/gnn/distributed.py``) at
         ogb_products' per-device block on pod16x16 (RING_W nodes a rank,
         RING_EB edges a bucket, every bucket full; GraphSAGE-reddit and
         EquiformerV2 at their configs, d_in 100, 47 classes) on a
         one-rank NCCL (1, 1) mesh and on two gloo ranks sharing the card
         (child processes): the loss and every gradient against the plain
         loss on the same graph on the card (RING_LOSS_RTOL,
         RING_GRAD_REL) with a float32 payload; each rank's forward-and-
         backward wall, peak beside x_loc plus one block and collective
         calls; on the NCCL rank also the forward alone, the collectives'
         counts and bytes (``hlo_analysis``) and EquiformerV2's bf16
         payload timed beside the float32 one; one AdamW step finite.
14. the static-analysis pass and the kernels' shared memory, each through
    ``run_phase``; neither launches a kernel:
    14a. ``python -m repro_torch.analysis src/repro_torch --json -`` as a
         child process must exit 0; the files checked and the allowlisted
         findings per rule are printed;
    14b. every kernel entry of the five ptxas reports: its static shared
         memory (ptxas) plus its binding's dynamic estimate (``smem_bytes``
         less ``STATIC_SMEM_BYTES``) at the largest input its paths gave it
         (B1 at the truss path's E and at the largest E whose lane state
         goes to shared memory, B2 at every n, each B3 instantiation at its
         widest D, B4 at DIN's D) must fit the card's per-block opt-in limit
         (torch's ``shared_memory_per_block_optin``, else
         ``cudaDeviceGetAttribute`` through ctypes); each binding's Python
         estimate must equal its source's ``<name>_smem_bytes`` export and
         its static part ptxas's; ``build.SMEM_BUDGET_BYTES`` must equal the
         limit.  A line per entry with the card's name and power limit.
15. the port's five examples (``examples/*_torch.py``) as child processes
    on the card, all started together after the parent has freed its cache,
    each with ``jax`` and ``repro`` blocked (``EXAMPLE_CHILD``), killed at
    EXAMPLES_TIMEOUT_S: each must exit 0; ``quickstart_torch`` and
    ``truss_analysis_torch`` must print exactly the reference examples'
    lines (``QUICKSTART_LINES``, ``TRUSS_ANALYSIS_LINES``) and launch B1 in
    their processes; ``serve_lm_torch`` 16 tokens of its first request;
    ``train_lm_torch`` (``--steps TRAIN_EXAMPLE_STEPS``) and
    ``train_gnn_truss_torch`` finite losses.  Each child's wall, its own
    launches and the phase's total are printed.

Six main paths: the truss path (phases 3-5d), the maintenance path (8a),
the mesh path (9a), the LM path (phase 7, and 7b and 7c, each read on its
own), the DIN path (11a, 11b and 11c, each read on its own) and the cell
path (13b, each cell read on its own); 5e-5h, 8b-8e, 9b, 9c, 10, 11d, 11e,
12, 13a, 13c, 14 and 15 read their own launches, each through ``run_phase``
(phases 10, 11d, 12c, 13c, 14 and 15 must launch none in this process).
Every launch counter is set to 0 just before each and read just after it,
and each kernel of the path must have launched (B1 and B2 on the truss
path, B1 on the maintenance and the mesh paths, B3 on the LM path, B4 on
the DIN path and on DIN's serve and retrieval cells).  The kernels are then
checked and timed again on the largest inputs their path gave them (B3:
the largest of its global and of its windowed calls, and at D = 128 the
largest call of 7b and of 7c; B4: each of 11b's four calls).  The line before
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

import atexit
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
F32_FLOPS = 67e12

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
# lengths that are not a multiple of the tiles (128 query rows; 128, 64 or
# 32 keys), windows of 20, 96 and 1024 keys, the non-causal branch, and
# D = 128 with GQA (group 4, as phi3.5-moe) over more than one pair of query
# blocks; also run in bf16 at B3_TOL.
B3_CASES = ((2, 4, 2, 200, 64, None, True), (1, 8, 8, 130, 128, None, True),
            (2, 4, 1, 250, 64, 96, True), (1, 2, 2, 500, 32, 20, True),
            (1, 4, 2, 300, 48, 20, True), (1, 4, 2, 190, 80, 96, True),
            (1, 8, 4, 1100, 256, 1024, True), (1, 8, 4, 333, 192, 20, True),
            (1, 4, 2, 190, 16, 40, False), (1, 4, 4, 150, 128, None, False),
            (1, 8, 2, 1000, 128, None, True))
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
B3_DESIGN = ("bf16: tensor cores, warp-specialised: one persistent block "
             "an SM walking pairs of 128-row query blocks (longest with "
             "shortest); a producer warpgroup (setmaxnreg 24) whose one "
             "thread issues TMA loads of Q and of 16 KB K/V tiles (64 keys "
             "at D = 128, 32 at D = 256) into a two-stage mbarrier ring "
             "through 4-D tensor maps, 128-byte swizzle; two consumer "
             "warpgroups (setmaxnreg 240, 64 rows each) that ping-pong on "
             "named barriers, each issuing the next tile's S = Q K^T (wgmma "
             "m64nKk16, shared memory) with this tile's O += P V (m64nDk16, "
             "P split into bf16 P_hi + P_lo in registers) before its "
             "softmax; float32: CUDA-core FMAs")
# B3 on the LM paths' largest calls is timed in this many turns of
# time_ms; its ms is their median, printed with the slowest and fastest
B3_TURNS = 10
# B4 in float32: sums of L = 100 rows of N(0, 1) values in other orders.
# A recursive float32 sum errs by at most about L 2^-24 sum|x| (~5e-4 for
# sum|x| ~ 80); a sum that cancels to near 0 is held by atol, not rtol.
B4_TOL = dict(rtol=1e-5, atol=5e-4)
# B4 in bf16: both sum in float32 and round once to bf16, so they differ by
# one bf16 step (at most 2^-7 |out|) where their float32 sums straddle a
# rounding point; near 0 the float32 orders differ by B4_TOL's atol.
B4_BF16_TOL = dict(rtol=2 ** -7, atol=B4_TOL["atol"])
B4_DESIGN = ("two entries by bag length. Rows read as the widest vector "
             "that divides the row and the table's address (D = 18 float32: "
             "float2, 9 lanes a row, 3 rows a load instruction). Small bags "
             "(L <= kernel.L_SMALL): a lane group per bag, 3 bags a load "
             "instruction at D = 18, indices read directly (the next "
             "position's in flight with the rows), 8 bags a lane in flight, "
             "a grid of SMs x resident blocks striding over the bags, float32 "
             "sums in bag order. Long bags: a warp per bag, its indices "
             "staged in shared memory, 128 at a time (the next 128 in "
             "flight), 8 row loads (__ldg) a lane in flight, float32 sums of "
             "the row groups combined by shuffles")
# B5 against its plain version in float32: both sum the same float32 terms,
# in other orders (the online softmax merges running maxima and sums).
B5_F32_TOL = dict(rtol=2e-5, atol=2e-5)
# B5 in bf16: both widen the same bf16 values exactly, compute in float32
# and round the output once, so they differ by one bf16 step (at most 2^-7
# |o|) where their float32 values straddle a rounding point; atol covers
# outputs near 0.
B5_TOL = dict(rtol=2 ** -7, atol=2e-3)
# B5 cases (B, S, Hkv, group, D, window), positions drawn per row in [0, S)
# with rows at 0 and S - 1: every group bucket (1, 2, 4, 8; 3 and 5 partly
# used), lane widths 1-32 (D = 8, 24, 200: lanes partly used), windows
# below and above the positions, splits and none; then the path's shapes:
# DeepSeekMoE-16B at 160 requests (MHA 16 x 128), gemma3-4b's local and
# global layers (8 x 4 kv heads of 256, group 2) and phi3.5-moe's (group 4)
B5_CASES = ((16, 40, 2, 1, 16, None), (3, 300, 2, 2, 8, 50),
            (5, 129, 3, 3, 24, None), (2, 700, 1, 5, 128, 100),
            (7, 64, 2, 8, 200, None), (4, 1000, 4, 4, 256, 256),
            (1, 1, 1, 1, 128, None), (160, 640, 16, 1, 128, None),
            (8, 2080, 4, 2, 256, 1024), (8, 2080, 4, 2, 256, None),
            (8, 2080, 8, 4, 128, None))
# B5 timed at the path's layer shapes: (label, B, S, Hkv, group, D, window,
# pos); every row at one position, as serve.generate's batches are (the
# b160 cell's mean step, gemma3-4b's middle step of phase 7)
B5_TIMED = (("dsmoe16b.decode_b160 layer", 160, 640, 16, 1, 128, None, 575),
            ("gemma3-4b local layer", 8, 2080, 4, 2, 256, 1024, 2063),
            ("gemma3-4b global layer", 8, 2080, 4, 2, 256, None, 2063))
B5_DESIGN = ("bytes: one block a (row, kv head, split) over the row's "
             "visible positions only; 16-byte cp.async loads (a lane 8 "
             "values of a position's head row, 16 lanes a 256-byte row at D "
             "= 128 bf16), a 4-stage ring a warp in shared memory, 3 stages "
             "in flight; float32 CUDA-core FMAs, an online softmax a row "
             "group merged by shuffles and across warps in shared memory; "
             "splits from the shape (none at 160 x 16 pairs), a combine "
             "launch when split")
# DIN's embedding table (V x D float32) and its bags of L: serve_p99 and
# serve_bulk batches
DIN_V, DIN_D, DIN_L, DIN_BATCHES = 10_000_000, 18, 100, (512, 262_144)
# B4 before this design (one thread per output element), (B, mode): ms at
# DIN's f32 shapes on an H100 80GB HBM3 at 700 W (PERF.md, run H)
B4_RUN_H_MS = {(512, "sum"): 0.0382, (512, "mean"): 0.0236,
               (262_144, "sum"): 1.3980, (262_144, "mean"): 1.3977}
# B4 at every branch of its layout, each case through both entries (dtype,
# D, B, L, table offset in elements; V = 100,000): float2 / bf16x2 rows of 9
# lanes (D = 18), the 4- and 2-byte fallbacks (D = 17), float4 and one row a
# load (D = 128, bf16: two rows), passes over a wide row (D = 256), a table
# 4 bytes off 16-byte alignment (4-byte loads at D = 128), L = 1, L over the
# 128 staged indices (300, 130), B = 1; then the small bags (L = 1, 2, 3, 7)
# in float32 and bf16 at D = 17, 18, 128 and 256, with tables one element
# off (4- and 2-byte loads, passes over 128 and 256 vectors), B = 1 and B
# not a multiple of the bags a warp tile takes (24 at D = 18).
B4_CASES = (("float32", 18, 1000, 100, 0), ("bf16", 18, 1000, 100, 0),
            ("float32", 17, 1000, 100, 0), ("bf16", 17, 1000, 7, 0),
            ("float32", 128, 1000, 100, 0), ("bf16", 128, 1000, 130, 0),
            ("float32", 256, 1000, 100, 0), ("float32", 128, 1000, 100, 1),
            ("float32", 18, 1000, 1, 0), ("float32", 18, 1000, 300, 0),
            ("float32", 18, 1, 100, 0), ("float32", 256, 1, 1, 0),
            ("bf16", 18, 1001, 1, 0), ("float32", 18, 1003, 2, 0),
            ("float32", 17, 997, 3, 0), ("bf16", 17, 1, 7, 0),
            ("float32", 128, 1001, 7, 1), ("bf16", 128, 999, 2, 0),
            ("float32", 256, 1001, 3, 0), ("bf16", 256, 1, 1, 1),
            ("float32", 18, 1, 1, 1), ("bf16", 18, 25, 3, 1))
# phase 2's sweep of B4 over the bag length on DIN's table: L, at
# B4_SWEEP_IDS ids each (B = B4_SWEEP_IDS // L), sum
B4_SWEEP_L = (1, 2, 4, 8, 16, 32, 100)
B4_SWEEP_IDS = 26_214_400
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

# phases 7b and 7c: MoE serving at full width, (tag, arch, layers kept;
# None: all).  phi3.5-moe's 32 layers hold 78.0 GiB of bf16 parameters, more
# than one card holds beside a cache: its depth is cut to 8 layers (19.9
# GiB) and its widths kept.
MOE_SERVE = (("7b", "moonshot-v1-16b-a3b", None),
             ("7c", "phi3.5-moe-42b-a6.6b", 8))
# phase 7's traffic: requests, prompt tokens, greedy steps, max_seq
LM_TRAFFIC = (8, 2048, 32, 2080)
# 7b, 7c: last-token logits of the flash prefill against the plain path's,
# on the requests whose routing agreed in every layer and, all of them, with
# the flash prefill's routing replayed on the plain path.  bf16 noise flips
# some token's experts in every request: on an H100 80GB HBM3 at 700 W no
# request of 7b or 7c routed alike in every layer (about 50,000 of 7b's
# token-layer pairs a request differ), and the flash and plain logits
# differed by 0.252 at most (7b; logits up to 4.22).  With the routing
# replayed they differed by 0.0859 at most (7b; 7c 0.0391), so the limit
# (phase 7's) leaves about twice that.
MOE_LOGITS_TOL = dict(rtol=0.05, atol=0.15)
# 7d: rows of 7b's layer-0 FFN input that _moe_ffn takes on the card and on
# the host.  A token whose router probabilities (float32) have two of their
# K + 1 largest closer than ROUTE_EPS may order or choose its experts
# differently on the two: the card's and the host's probabilities differed
# by 1.5e-7 at most (H100 80GB HBM3, 700 W).  The outputs of the tokens
# routed alike differ where bf16 rounds matmuls summed in other orders: one
# or two bf16 steps (0.0156 at |out| up to 2.03 on that card); aux by a
# float32 sum's rounding.
MOE_ROWS = 256
ROUTE_EPS = 1e-5
MOE_FFN_TOL = dict(rtol=2 ** -6, atol=2 ** -6)
MOE_AUX_TOL = dict(rtol=1e-5, atol=0.0)

# phase 10: training.  10a holds each reduced LM arch's loss, aux and
# gradients on the card to the same call on the host at the CPU tests'
# tolerance (tests/test_torch_train.py), and one make_train_step at
# TRAIN_TOL, its parameters at TRAIN_STEP_TOL: a first AdamW step moves a
# parameter by lr * g / (|g| + eps), which for a gradient near eps turns on
# its last bits (a tenth of the learning rate).  The train loop runs
# TRAIN_LOOP_STEPS steps of qwen2.5-14b's reduced config; the fault run
# raises at TRAIN_FAULT_STEP and must replay to the same losses.
TRAIN_TOL = dict(rtol=2e-5, atol=2e-6)
TRAIN_LR = 1e-3
TRAIN_STEP_TOL = dict(rtol=0.0, atol=TRAIN_LR / 10)
TRAIN_LOOP_STEPS, TRAIN_FAULT_STEP, TRAIN_CKPT_EVERY = 40, 17, 10
# 10b: one gemma3-4b global layer at full width in float32 (TF32 off), card
# against host, on LAYER_TOKENS tokens: each gradient's largest difference
# at most LAYER_GRAD_RTOL of its largest magnitude (float32 sums over 512
# tokens and 10,240-wide rows in other orders)
LAYER_TOKENS, LAYER_INDEX, LAYER_GRAD_RTOL = 512, 5, 1e-4
# 10c: gemma3-4b trained at full width, one TokenStream sequence a step
TRAIN_SEQ, TRAIN_STEPS = 4096, 3
BF16_FLOPS_PER_S = 989e12

# phase 11: DIN at full width (configs/din.py).  11a holds the card's
# scores (the B4 route) to the host's (the take) on the same weights: the
# two sum the MLPs' float32 products (K = 72 to 200) in other orders; the
# CPU tests hold the port to JAX at 1e-5 relative and 1e-6 absolute, and
# DIN_TOL leaves ten times that.  11c holds 512
# candidates' retrieval scores to din_scores of the same pairs at the
# reference's own tolerance (tests/test_arch_smoke.py::
# test_din_retrieval_consistent): the two run the same ops on batches of
# other sizes.  DIN_BATCH_STEPS: the RecsysStream step of each shape's batch
DIN_TOL = dict(rtol=1e-4, atol=1e-5)
DIN_RETRIEVAL_TOL = dict(rtol=1e-5, atol=1e-5)
DIN_RETRIEVAL_CHECK = 512
DIN_TRAIN_STEPS = 3
# phase 12: GNNs.  12a holds each reduced GNN arch and DIN on the card to
# the host at the CPU tests' tolerances (tests/test_torch_gnn.py,
# test_torch_din.py): the loss at GNN_TOL, each gradient leaf at
# GNN_GRAD_RTOL with a floor of GNN_GRAD_ATOL times the tree's largest
# gradient.  12b: one EquiformerV2 block at full width on EQV2_BLOCK_GRAPHS
# molecules (2,048 directed edges), float32 (TF32 off), card against host:
# each gradient's largest difference at most EQV2_GRAD_RTOL of its largest
# magnitude (10b's limit: matmuls with K up to 896 and segment sums in other
# orders).  12c: GNN_TRAIN_STEPS steps of each training run.  The uniform
# GraphSAGE batch is sampled from an Erdos-Renyi graph with Reddit's
# 232,965 nodes and a fiftieth of its 114,615,892 edges (REDDIT_EDGES, what
# builds on the host in about 20 s: a fifth took 210.8 s on the H100's
# host, 8 cores): the batch's shape does not depend on the edge count.
# The molecule shape's 64 edges a graph are undirected (gnn_family's
# _flat_sizes counts 2 x 64 directed ones), and gnn_molecule_batch takes
# the directed count.  FP32_FLOPS_PER_S: the H100's float32 peak outside the
# tensor cores, which these float32 models run on with TF32 off.
GNN_TOL = dict(rtol=1e-5, atol=1e-6)
GNN_GRAD_RTOL, GNN_GRAD_ATOL = 1e-4, 1e-6
EQV2_BLOCK_GRAPHS, EQV2_GRAD_RTOL = 16, 1e-4
GNN_TRAIN_STEPS = 3
REDDIT_EDGES = 114_615_892 // 50
FP32_FLOPS_PER_S = 67e12

# phase 13: the cell and dry-run layer.  13a: the dry run of every cell on
# pod16x16 (a fake 256-rank group, no card) in a child process started when
# the smoke starts, DRYRUN_JOBS worker processes, all at nice 19 so that
# the host-bound phases 2-12 beside it keep their cores; the smoke waits for
# it at most DRYRUN_WAIT_S once phase 12 is done (phases 1-12 end about
# 700 s in and the child has taken 518-686 s; 300 s more keeps the smoke
# under 1,100 s even then).  2pod16x16 is not traced here:
# its LM training cells and EquiformerV2's 512-step ring take longer than
# the smoke's budget on the host.  13b runs CELL_RUNS for real on a one-rank
# NCCL (1, 1) mesh, each against the dry run's (1, 1) record of the same
# cell (DRY11_CHILD): arg_bytes exactly, and temp_bytes against the card's
# max_memory_allocated less what was held before the step, within a factor
# TEMP_FACTOR of each other once both are raised to TEMP_FLOOR (allocator
# rounding and small workspaces are not in the dry run).  B4 launches on
# DIN's serve and retrieval cells (CELL_B4) and nowhere else.  13c: both
# ring losses at the production per-device block of ogb_products on
# pod16x16 (RING_W nodes a rank, RING_EB edges a bucket, full buckets), on
# a one-rank NCCL mesh and on two gloo ranks sharing the card
# (RING_CHILD), against the plain losses on the same graph on the card at
# the reference test's tolerances (RING_LOSS_RTOL, RING_GRAD_REL).
DRYRUN_JOBS, DRYRUN_WAIT_S = 7, 300
CELL_RUNS = (("gat-cora", "full_graph_sm"), ("gat-cora", "molecule"),
             ("graphsage-reddit", "full_graph_sm"),
             ("graphsage-reddit", "minibatch_lg"),
             ("meshgraphnet", "molecule"), ("equiformer-v2", "molecule"),
             ("din", "train_batch"), ("din", "serve_p99"),
             ("din", "serve_bulk"), ("din", "retrieval_cand"))
CELL_B4 = {"serve_p99": 4, "serve_bulk": 4, "retrieval_cand": 102}
TEMP_FACTOR, TEMP_FLOOR = 2.0, 64 * 2 ** 20
RING_P, RING_W, RING_EB = 256, 9567, 3775
RING_LOSS_RTOL, RING_GRAD_REL = 2e-4, 5e-3

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

# phase 15: what examples/quickstart.py and examples/truss_analysis.py
# print (the JAX package's runs on the CPU; tests/test_torch_examples.py
# holds those runs and the port's examples on the CPU to these lines)
QUICKSTART_LINES = (
    "k-classes of the Figure-2 graph:",
    "  Phi_2: (i,k)",
    "  Phi_3: (d,g) (d,k) (d,l) (e,f) (e,g) (f,g) (g,h) (g,k) (g,l)",
    "  Phi_4: (f,h) (f,i) (f,j) (h,i) (h,j) (i,j)",
    "  Phi_5: (a,b) (a,c) (a,d) (a,e) (b,c) (b,d) (b,e) (c,d) (c,e) (d,e)",
    "  k_max = 5  (the 5-truss is the clique a-e)",
    "bottom-up (budget=10 edges) and top-down agree. bottom-up used 9 "
    "partition rounds, 42 scans.",
)
TRUSS_ANALYSIS_LINES = (
    "R-MAT graph: n=8192, m=67568",
    "k_max-truss: k=43, |V|=90, |E|=3192, CC=0.81",
    "c_max-core : c=60, |V|=92, |E|=3315, CC=0.81",
    "max clique is <= k_max = 43 (vs the weaker c_max+1 = 61)",
    "top-down Phi_43: 3192 edges (candidate subgraphs: [4112, 5705, 8921, "
    "10495]...)",
    "top-down Phi_42: 63 edges (candidate subgraphs: [4112, 5705, 8921, "
    "10495]...)",
)


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


def time_turns(torch, fn, reps: int, turns: int) -> tuple[float, list]:
    """``turns`` readings of :func:`time_ms` one after another, and their
    median."""
    got = [time_ms(torch, fn, reps) for _ in range(turns)]
    return float(np.median(got)), got


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
    """Least time of an embedding bag: the distinct rows it gathers (each
    read once: what these ids need), the indices and the output moved once
    over the memory rate."""
    B, L = idx.shape
    row = table.shape[1] * table.element_size()
    rows = int(idx.unique().numel())
    return (rows * row + B * L * 4 + B * row) / HBM_BYTES_PER_S * 1e3


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
    instructions; raise unless the bf16 D = 256 (gemma3-4b) and D = 128 (the
    MoE configs) instantiations run on tensor cores and spill nothing.
    Returns their figures by D."""
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
    out = {}
    for d in (256, 128):
        top = rows.get(("tc", d))
        if top is None:
            raise AssertionError(f"no bf16 D = {d} instantiation of B3 in "
                                 f"the ptxas report")
        if top["hgmma"] + top["hmma"] == 0:
            raise AssertionError(f"B3's bf16 D = {d} instantiation has no "
                                 f"tensor-core instruction in its SASS")
        if top["spill_stores"]:
            raise AssertionError(f"B3's bf16 D = {d} instantiation spills "
                                 f"{top['spill_stores']} bytes")
        out[d] = top
    return out


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


B4_ENTRY_RE = (r"(embedding_bag_kernel|embedding_bag_small|gather_probe)"
               r"I(f|13__nv_bfloat16)Li(\d+)E")
# B4's entries by their kernel function
B4_ENTRY_FN = {"warp": "embedding_bag_kernel", "small": "embedding_bag_small"}


def b4_build_check(build) -> dict:
    """Print what ptxas made of every instantiation of B4's two entries and
    of the gather probe; raise if one spills or an entry is missing.
    Returns the figures by (function, dtype, load bytes)."""
    out = {}
    for name, r in ptxas_kernels(build.report("embedding_bag")).items():
        m = re.search(B4_ENTRY_RE, name)
        if m is None:
            continue
        key = (m[1], "float32" if m[2] == "f" else "bf16", int(m[3]))
        say(f"[1]   B4 {key[0]} {key[1]} {key[2]}-byte loads: "
            f"{r['registers']} "
            f"registers, {r['spill_stores']} bytes spill stores, "
            f"{r['stack']} bytes stack, {r['static_smem']} bytes static "
            f"shared memory")
        out[key] = r
    spills = {k: r["spill_stores"] for k, r in out.items()
              if r["spill_stores"]}
    if spills:
        raise AssertionError(f"B4 spills (bytes): {spills}")
    for fn in B4_ENTRY_FN.values():
        if not any(k[0] == fn for k in out):
            raise AssertionError(f"no {fn} in the ptxas report")
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


def check_b4(torch, bk, bref, table, idx, mode: str, where: str,
             use=None) -> float:
    """B4 (the entry ``use``; None: the one the bag length takes) against
    its plain version on the same inputs: a sum of one row exactly (DIN's
    lookups), else within B4_TOL (float32) or B4_BF16_TOL (bf16); returns
    the max abs error."""
    tol = B4_TOL if table.dtype == torch.float32 else B4_BF16_TOL
    got = bk.embedding_bag(table, idx, mode=mode, use=use)
    want = bref.embedding_bag(table, idx, mode=mode)
    torch.cuda.synchronize()
    err = float((got.float() - want.float()).abs().max())
    exact = mode == "sum" and idx.shape[1] == 1
    if got.dtype != want.dtype or got.shape != want.shape or not (
            torch.equal(got, want) if exact
            else torch.allclose(got.float(), want.float(), **tol)):
        raise AssertionError(f"B4 embedding_bag ({use or 'dispatch'}) "
                             f"differs from its plain version {where} "
                             f"{mode}: max abs err {err}"
                             f"{' (must be exact)' if exact else ''}")
    return err


def b4_sweep(torch, F, bk, bref, gen, table, dev) -> list:
    """Phase 2's sweep of B4 over the bag length on DIN's float32 table:
    for each L of ``B4_SWEEP_L``, B = ``B4_SWEEP_IDS`` // L bags drawn as
    phase 2 draws them, in ``sum`` mode (DIN's).  Both entries are checked
    against the plain version and timed; the one ``bk.entry(L)`` takes is
    also timed in a CUDA graph, beside the library call
    (``torch.index_select`` at L = 1, ``F.embedding_bag`` above) and the
    byte bound.  This sets ``kernel.L_SMALL``."""
    rows = []
    for L in B4_SWEEP_L:
        B = B4_SWEEP_IDS // L
        idx = torch.randint(0, DIN_V, (B, L), generator=gen, device=dev,
                            dtype=torch.int32)
        use = bk.entry(L)
        err = max(check_b4(torch, bk, bref, table, idx, "sum",
                           f"in the sweep at L={L}", u) for u in bk.ENTRIES)
        ms = {u: time_ms(torch, lambda: bk.embedding_bag(
            table, idx, mode="sum", use=u), 20) for u in bk.ENTRIES}
        graph = graph_ms(torch, lambda: bk.embedding_bag(table, idx,
                                                         mode="sum"), 20)
        if L == 1:
            ids = idx.reshape(-1).long()
            library = "torch.index_select"
            lib = time_ms(torch, lambda: torch.index_select(table, 0, ids),
                          20)
            del ids
        else:
            library = "F.embedding_bag"
            lib = time_ms(torch, lambda: F.embedding_bag(idx, table,
                                                         mode="sum"), 20)
        row = dict(L=L, B=B, entry=use, ms=ms[use], graph_ms=graph,
                   small_ms=ms["small"], warp_ms=ms["warp"],
                   library=library, library_ms=lib,
                   bound_ms=b4_bound_ms(table, idx), max_abs_err=err)
        rows.append(row)
        say(f"[2] B4 sweep V={DIN_V:,} D={DIN_D} float32 L={L} B={B:,} "
            f"sum: entry {use}, kernel {row['ms']:.4f} ms (in a CUDA graph "
            f"{graph:.4f} ms); small entry {ms['small']:.4f} ms, warp entry "
            f"{ms['warp']:.4f} ms; {library} {lib:.4f} ms; bound "
            f"{row['bound_ms']:.4f} ms (bytes); max abs err {err:.3g}")
        del idx
    return rows


def b4_phase(torch, F, bk, bref, gen, builds, dev) -> dict:
    """Phase 2 for B4: every case of B4_CASES in sum and mean through both
    entries, then DIN's table (10,000,000 x 18, float32 and bf16) at
    serve_p99 (512 bags) and serve_bulk (262,144 bags) of 100: checked,
    timed beside run H, the plain version, F.embedding_bag, the byte bound,
    the sector and segment traffic (derived from the shapes, not measured)
    and the gather probe's floor.  The kernel is also timed in a CUDA graph
    (its device time without the host's cost of a call), and so is the
    probe.  Then :func:`b4_sweep` over the bag length.  Returns the
    kernels-line entry (serve_bulk, float32, mean), the sweep under
    "sweep"."""
    dtypes = {"float32": torch.float32, "bf16": torch.bfloat16}
    for dname, D, B, L, offset in B4_CASES:
        V = 100_000
        flat = torch.randn(V * D + offset, generator=gen, device=dev)
        table = flat.to(dtypes[dname])[offset:].view(V, D)
        idx = torch.randint(0, V, (B, L), generator=gen, device=dev,
                            dtype=torch.int32)
        lay = bk.layout(D, table.element_size(), table.data_ptr())
        where = f"at {dname} D={D} B={B} L={L} offset {offset}"
        errs = {(use, mode): check_b4(torch, bk, bref, table, idx, mode,
                                      where, use)
                for use in bk.ENTRIES for mode in bk.MODES}
        say(f"[2] B4 embedding_bag {dname} D={D} B={B} L={L} table offset "
            f"{offset}: {lay.vec}-byte loads, {lay.chunks} a row, "
            f"{lay.rows} rows a load, {lay.passes} pass(es); dispatch "
            f"{bk.entry(L)}; max abs err " + ", ".join(
                f"{use} {mode} {e:.3g}" for (use, mode), e in errs.items()))
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
                        build_small=builds.get(("embedding_bag_small",
                                                "float32", lay.vec)),
                        note="no model path of the JAX package reaches "
                        "embedding_bag; timed at DIN serve_bulk")
            del tbl
        del idx
    out["sweep"] = b4_sweep(torch, F, bk, bref, gen, table, dev)
    return out


B5_KERNEL_RE = (r"decode_attention_(kernel|combine)I(f|13__nv_bfloat16)"
                r"(?:Li(\d+)E)?")


def b5_build_check(build) -> dict:
    """Print what ptxas made of every B5 instantiation (the kernel by dtype
    and group bucket, and the combine) and its cp.async (LDGSTS) and
    tensor-core instructions (cuobjdump -sass); raise if one spills, uses a
    tensor core, or an instantiation of the kernel has no cp.async.
    Returns the figures by (function, dtype, group)."""
    exe = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([exe, "-sass", str(build.target(
        "decode_attention"))], capture_output=True, text=True, check=True,
        timeout=300).stdout
    ops, name = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            name = m[1]
            ops[name] = dict(ldgsts=0, mma=0)
        elif name is not None:
            ops[name]["ldgsts"] += "LDGSTS" in line
            ops[name]["mma"] += any(op in line for op in (
                "HGMMA", "HMMA", "IGMMA", "IMMA"))
    out = {}
    for name, r in ptxas_kernels(build.report("decode_attention")).items():
        m = re.search(B5_KERNEL_RE, name)
        if m is None:
            continue
        key = (m[1], "float32" if m[2] == "f" else "bf16",
               int(m[3]) if m[3] else None)
        r.update(ops.get(name, dict(ldgsts=0, mma=0)))
        say(f"[1]   B5 decode_attention_{key[0]} {key[1]}"
            f"{'' if key[2] is None else f' group <= {key[2]}'}: "
            f"{r['registers']} registers, {r['spill_stores']} bytes spill "
            f"stores, {r['stack']} bytes stack, {r['static_smem']} bytes "
            f"static shared memory, LDGSTS {r['ldgsts']}, MMA {r['mma']}")
        out[key] = r
    bad = [f"{k}: spills {r['spill_stores']} bytes" for k, r in out.items()
           if r["spill_stores"]]
    bad += [f"{k}: {r['mma']} tensor-core instructions" for k, r in
            out.items() if r["mma"]]
    bad += [f"{k}: no cp.async (LDGSTS)" for k, r in out.items()
            if k[0] == "kernel" and not r["ldgsts"]]
    want = {("kernel", dt, g) for dt in ("float32", "bf16")
            for g in (1, 2, 4, 8)} | {("combine", dt, None)
                                      for dt in ("float32", "bf16")}
    bad += [f"{k}: not in the ptxas report" for k in sorted(
        want - set(out), key=str)]
    if bad:
        raise AssertionError("B5 build: " + "; ".join(bad))
    return out


def b5_inputs(torch, gen, dev, B, S, Hkv, g, D, dtype):
    """q (B, 1, Hkv g, D) and a cache ck, cv (B, S, Hkv, D) of N(0, 1)
    values in ``dtype``."""
    q = torch.randn((B, 1, Hkv * g, D), generator=gen, device=dev).to(dtype)
    ck = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    cv = torch.randn((B, S, Hkv, D), generator=gen, device=dev).to(dtype)
    return q, ck, cv


def b5_hidden(torch, ck, pos, window):
    """(B, S, 1, 1) True where a row cannot see the position."""
    t = torch.arange(ck.shape[1], device=ck.device)[None, :]
    p = pos.long()[:, None]
    hidden = t > p
    if window is not None:
        hidden |= t <= p - window
    return hidden[:, :, None, None]


def check_b5(torch, dk, dref, q, ck, cv, pos, window, where: str) -> float:
    """B5 on the cache with every position a row cannot see set to NaN
    against the plain version on the same cache with them 0, so a hidden
    position that the kernel loads shows as a NaN; raises beyond B5_TOL /
    B5_F32_TOL or on a non-finite output.  Returns the max abs error."""
    hidden = b5_hidden(torch, ck, pos, window)
    nan = float("nan")
    got = dk.decode_attention(q, ck.masked_fill(hidden, nan),
                              cv.masked_fill(hidden, nan), pos, window)
    want = dref.decode_attention(q, ck.masked_fill(hidden, 0),
                                 cv.masked_fill(hidden, 0), pos, window)
    torch.cuda.synchronize()
    tol = B5_F32_TOL if q.dtype == torch.float32 else B5_TOL
    err = float((got.float() - want.float()).abs().max())
    if not bool(torch.isfinite(got).all()) or not torch.allclose(
            got.float(), want.float(), **tol):
        raise AssertionError(f"B5 decode_attention differs from its plain "
                             f"version {where}: max abs err {err} (a NaN: "
                             f"a hidden position was read)")
    return err


def b5_bound(q, ck, pos, window) -> tuple[float, str]:
    """Least time of one call: each row's visible keys and values read once
    and q and the output moved once (over the memory rate), against 4 Hq D
    flops a visible position over the float32 CUDA-core peak; the larger."""
    S = ck.shape[1]
    p = pos.long()
    first = (p - window + 1).clamp(min=0) if window is not None else 0 * p
    keys = int(((p.clamp(max=S - 1) - first + 1).clamp(min=0)).sum())
    item = ck.element_size()
    byt = (2 * keys * ck.shape[2] * ck.shape[3] + 2 * q.numel()) * item \
        / HBM_BYTES_PER_S * 1e3
    ops = 4 * keys * q.shape[2] * q.shape[3] / F32_FLOPS * 1e3
    return (ops, "operations") if ops > byt else (byt, "bytes")


def b5_sdpa(torch, F, q, ck, cv, pos, window):
    """The library yardstick for B5: one scaled_dot_product_attention call
    on the cache's (B, Hkv, S, D) views with a boolean mask of each row's
    visible positions (never called by the port)."""
    hidden = b5_hidden(torch, ck, pos, window)[:, None, None, :, 0, 0]
    return F.scaled_dot_product_attention(
        q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2),
        attn_mask=~hidden, enable_gqa=True)


def b5_launches(dk, cfg, n_req: int, max_seq: int, steps: int) -> int:
    """B5's launches over ``steps`` decode steps of ``cfg`` at ``n_req``
    rows and a cache of ``max_seq``: one a layer, two where the split plan
    splits (the plan reads the shape alone; the card's SMs)."""
    import torch
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    per_step = 0
    for i in range(cfg.n_layers):
        local = cfg.pattern[i % len(cfg.pattern)] == "local"
        span = min(max_seq, cfg.window) if local else max_seq
        per_step += 1 + (dk.split_plan(n_req * cfg.n_kv, span, sms) > 1)
    return per_step * steps


def b5_phase(torch, F, dk, dref, gen, dev) -> dict:
    """Phase 2 for B5: every case of B5_CASES in float32 and bf16 (hidden
    positions NaN, ragged positions), then B5_TIMED in bf16: the kernel
    (median of B3_TURNS turns), the plain version, SDPA and the bound.
    Returns the kernels-line entry (the b160 layer) with every timed row
    under "timed"."""
    for B, S, Hkv, g, D, window in B5_CASES:
        pos = torch.randint(0, S, (B,), generator=gen, device=dev,
                            dtype=torch.int32)
        pos[0], pos[-1] = 0, S - 1
        errs = {}
        for dt in (torch.float32, torch.bfloat16):
            q, ck, cv = b5_inputs(torch, gen, dev, B, S, Hkv, g, D, dt)
            errs[str(dt).split(".")[1]] = check_b5(
                torch, dk, dref, q, ck, cv, pos, window,
                f"at (B,S,Hkv,g,D)={(B, S, Hkv, g, D)} window {window} {dt}")
            del q, ck, cv
        nsplit = dk.split_plan(B * Hkv, S if window is None else min(
            S, window), torch.cuda.get_device_properties(0)
            .multi_processor_count)
        say(f"[2] B5 decode_attention (B,S,Hkv,g,D)={(B, S, Hkv, g, D)} "
            f"window {window}: {nsplit} split(s); max abs err "
            + ", ".join(f"{k} {e:.3g}" for k, e in errs.items())
            + f" (tol {B5_F32_TOL}, {B5_TOL})")
    rows = []
    for label, B, S, Hkv, g, D, window, p in B5_TIMED:
        pos = torch.full((B,), p, dtype=torch.int32, device=dev)
        q, ck, cv = b5_inputs(torch, gen, dev, B, S, Hkv, g, D,
                              torch.bfloat16)
        err = check_b5(torch, dk, dref, q, ck, cv, pos, window, label)
        l0 = dk.LAUNCHES
        dk.decode_attention(q, ck, cv, pos, window)
        launches = dk.LAUNCHES - l0
        ms, turns = time_turns(torch, lambda: dk.decode_attention(
            q, ck, cv, pos, window), 20, B3_TURNS)
        plain = time_ms(torch, lambda: dref.decode_attention(
            q, ck, cv, pos, window), 5)
        lib = time_ms(torch, lambda: b5_sdpa(torch, F, q, ck, cv, pos,
                                             window), 10)
        bound, by = b5_bound(q, ck, pos, window)
        row = dict(name="decode_attention.decode_attention", route="cuda",
                   source="src/repro_torch/csrc/decode_attention.cu",
                   replaces="none (the JAX package's decode is plain jnp, "
                   "src/repro/models/transformer.py _decode_attention)",
                   label=label, shape=[B, S, Hkv, g, D], window=window,
                   pos=p, launches_a_call=launches, max_abs_err=err, ms=ms,
                   ms_turns=turns, plain_ms=plain, library_ms=lib,
                   library="F.scaled_dot_product_attention (masked)",
                   bound_ms=bound, bound_by=by, roofline=bound / ms)
        say(f"[2] B5 decode_attention {label} (B,S,Hkv,g,D)="
            f"{(B, S, Hkv, g, D)} window {window} pos {p} bf16: max abs err "
            f"{err:.3g} (tol {B5_TOL}); {launches} launch(es) a call; kernel "
            f"{ms:.4f} ms (median of {B3_TURNS} turns, {min(turns):.4f}-"
            f"{max(turns):.4f}), plain {plain:.4f} ms, sdpa {lib:.4f} ms, "
            f"bound {bound:.4f} ms ({by}, {100 * bound / ms:.1f} % of it)")
        rows.append(row)
        del q, ck, cv
    out = dict(rows[0], design=B5_DESIGN)
    out["timed"] = [{k: r[k] for k in ("label", "shape", "window", "pos",
                                       "launches_a_call", "max_abs_err",
                                       "ms", "ms_turns", "plain_ms",
                                       "library_ms", "bound_ms", "bound_by")}
                    for r in rows]
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


# 8a's third case: an insertion that closes at least this many triangles
CLOSING_MIN_TRIANGLES = 25


def closing_insert(n: int, edges: np.ndarray,
                   min_triangles: int = CLOSING_MIN_TRIANGLES) -> list:
    """One insertion that closes triangles, drawn from a fresh
    ``default_rng(9)``: an endpoint w of a uniform edge of the canonical
    list ``edges``, two distinct neighbours of w drawn without replacement;
    the first such pair that is not an edge and whose endpoints share at
    least ``min_triangles`` neighbours (the triangles the insertion
    closes).  On R-MAT scale 15, seed 5, its region is peeled, so B1 runs
    where :func:`edit_batch`'s b = 1 insertion only splices."""
    rng = np.random.default_rng(9)
    edges = np.asarray(edges, np.int64)
    both = np.concatenate([edges, edges[:, ::-1]])
    both = both[np.lexsort((both[:, 1], both[:, 0]))]
    indptr = np.searchsorted(both[:, 0], np.arange(n + 1))
    present = {tuple(e) for e in edges.tolist()}

    def nbrs(x):
        return both[indptr[x]:indptr[x + 1], 1]

    while True:
        w = int(edges[rng.integers(0, len(edges)), rng.integers(0, 2)])
        nb = nbrs(w)
        if len(nb) < 2:
            continue
        u, v = sorted(int(x) for x in nb[rng.choice(len(nb), 2,
                                                     replace=False)])
        if (u, v) in present:
            continue
        if len(np.intersect1d(nbrs(u), nbrs(v),
                              assume_unique=True)) >= min_triangles:
            return [("insert", u, v)]


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
    "8a_b1_closing": dict(
        m=234_004, edits_applied=1, maintain_levels=21, affected_edges=59,
        sha256="2457be2ce39be22b5f31df11027110f6aa212a136efca8be0aaf672bb4326f54"),
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
    :func:`edit_batch`'s b = 1 and b = 64 edits and of
    :func:`closing_insert`'s one insertion from phase 4a's phi, each
    followed by a recompute of the maintained edge list on the card.  The
    maintained phi must equal the recompute bit for bit and the JAX
    package's digest (``MAINT_DIGESTS``); at b = 1 the recompute must take
    at least 5x the maintenance's wall (the reference's ``table5maint``
    gate; that insertion closes no triangle, so the gate times the splice),
    at b = 64 B1 must have launched, and the closing insertion must peel a
    region (``affected_edges`` and ``maintain_levels`` above 0, B1
    launched); its speedup is printed, not gated."""
    out = {}
    cases = (("b1", 1, edit_batch(n, edges, 1)),
             ("b64", 64, edit_batch(n, edges, 64)),
             ("b1_closing", 1, closing_insert(n, edges)))
    for key, b, steps in cases:
        what = f"b={b}" + (" closing" if key.endswith("closing") else "")
        tag, rtag = f"8a maintain {what} rmat15", f"8a recompute {what} rmat15"
        res = run_phase(tag, lambda: truss_maintain((n, edges), phi0, steps,
                                                    device=dev))
        phi_r = run_phase(rtag, lambda: truss_decompose(
            res.graph.n, res.graph.edges, device=dev))
        st = res.stats
        row = dict(b=b, edits=steps if b == 1 else len(steps),
                   m=res.graph.m, edits_applied=st.edits_applied,
                   maintain_levels=st.maintain_levels,
                   affected_edges=st.affected_edges,
                   wall_s=round(phase_walls[tag], 3),
                   recompute_s=round(phase_walls[rtag], 3),
                   speedup_vs_recompute=round(
                       phase_walls[rtag] / phase_walls[tag], 2),
                   launches=phase_launches[tag]["B1"])
        out[key] = row
        say(f"[8a] {key}: {row}")
        if not np.array_equal(res.phi, phi_r):
            raise AssertionError(f"8a: the maintained phi differs from the "
                                 f"recompute at {what}")
        check_maint(f"8a {what}", res, MAINT_DIGESTS[f"8a_{key}"])
    if out["b64"]["launches"] == 0:
        raise AssertionError("8a: the b=64 maintenance never launched B1")
    if out["b1"]["speedup_vs_recompute"] < 5:
        raise AssertionError(f"8a: speedup_vs_recompute "
                             f"{out['b1']['speedup_vs_recompute']} < 5 at "
                             f"b=1")
    closing = out["b1_closing"]
    if not (closing["affected_edges"] > 0 and closing["maintain_levels"] > 0
            and closing["launches"] > 0):
        raise AssertionError(f"8a: the closing insertion peeled no region: "
                             f"{closing}")
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
MAINT_KILL_EDIT = 4


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
    run's, ``resumed_round`` the edit before the kill, the ``maintain``
    site reached only by the edits after it, and B1 launched by the replay
    (the kill lands among the deletions, edits 0-7, whose regions peel)."""
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
    if out["resume"]["launches"] == 0:
        raise AssertionError("8b: the resume replayed no region peel (B1 "
                             "never launched)")
    return out


def table6(core_decompose, cmax_core, clustering_coefficient,
           incident_vertices, canonical_edges, run_phase, n, edges, phi,
           dev) -> dict:
    """Phase 8c, Table 6 on R-MAT scale 17: the core numbers
    (``core_decompose``, against the JAX package's digest) and the
    c_max-core (``cmax_core``) on the card, the k_max-truss from phase 3's
    phi, and the row of ``benchmarks/run.py::table6_truss_vs_core``; every
    number, the clustering coefficients too, must equal the JAX
    package's.  Returns the row and the k_max-truss's edges."""
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
    return dict(got, clustering_host_s=round(host_s, 3)), t_edges


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


# phase 9b's children: two ranks of one gloo group on the one card (NCCL
# refuses two ranks on one GPU), each running the same calls on R-MAT scale
# 13 and the dense supports on an ER core of 512 vertices.  They import
# only repro_torch; each prints one "MESH_RESULT {json}" line.
MESH_CHILD = r"""
import hashlib, json, sys, time
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.core import distributed as D
from repro_torch.core import faults
from repro_torch.core.graph import build_graph
from repro_torch.core.peel import estimate_working_set, truss_decompose
from repro_torch.core.support import list_triangles, support_from_triangle_list
from repro_torch.data.graphgen import erdos_renyi, rmat
from repro_torch.kernels.frontier_peel import kernel as fk
from repro_torch.kernels.triangle_count import kernel as tk

rendezvous, rank, plan = sys.argv[1], int(sys.argv[2]), json.loads(sys.argv[3])
torch.cuda.set_device(0)
dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                        rank=rank, world_size=2)
data = init_device_mesh("cuda", (2,), mesh_dim_names=("data",))
data_tri = init_device_mesh("cuda", (1, 2), mesh_dim_names=("data", "tri"))
n, e = rmat(13, 8, seed=5)
g = build_graph(n, e)
budget = estimate_working_set(g) // 16
out = {}


def run(tag, fn):
    torch.cuda.synchronize()
    l0, c0, t0 = fk.LAUNCHES, D.COLLECTIVES, time.perf_counter()
    res = fn()
    torch.cuda.synchronize()
    out[tag] = dict(wall_s=round(time.perf_counter() - t0, 3),
                    B1=fk.LAUNCHES - l0, collectives=D.COLLECTIVES - c0)
    return res


def record(tag, phi, st=None):
    out[tag]["sha256"] = hashlib.sha256(
        np.asarray(phi).astype(np.int64).tobytes()).hexdigest()
    if st is not None:
        out[tag].update({k: int(getattr(st, k)) for k in (
            "devices", "sharded_rounds", "rounds", "retries", "degraded")})


ooc = dict(memory_budget=budget, with_stats=True)
record("bottom-up", *run("bottom-up", lambda: truss_decompose(
    n, e, engine="bottom-up", mesh=data, **ooc)))
record("top-down", *run("top-down", lambda: truss_decompose(
    n, e, engine="top-down", mesh=data_tri, mesh_axes=("data", "tri"),
    **ooc)))
tris = list_triangles(g)
sup = support_from_triangle_list(tris, g.m)
record("peel_classes_sharded", run("peel_classes_sharded", lambda:
       D.peel_classes_sharded(data, sup, D.pad_triangles(tris, g.m, 2),
                              np.ones(g.m, bool)).cpu()))
rule = faults.FaultRule(kind="oom", **plan)
with faults.active(faults.FaultPlan([rule])) as active_plan:
    record("mesh-drop", *run("mesh-drop", lambda: truss_decompose(
        n, e, engine="bottom-up", mesh=data, **ooc)))
out["mesh-drop"]["fired"] = len(active_plan.log)
er = torch.as_tensor(erdos_renyi(512, 19_600, seed=5), device="cuda")
A = torch.zeros((512, 512), device="cuda")
A[er[:, 0], er[:, 1]] = A[er[:, 1], er[:, 0]] = 1
ring = run("ring_support_dense", lambda: D.ring_support_dense(data, A))
gath = run("allgather_support_dense",
           lambda: D.allgather_support_dense(data, A))
s_b2 = tk.triangle_count(A.to(torch.uint8), symmetric=True)
on = A > 0
for tag, S in (("ring_support_dense", ring),
               ("allgather_support_dense", gath)):
    out[tag]["equals_b2_on_edges"] = bool(torch.equal(S[on].int(), s_b2[on]))
    out[tag]["zero_off_edges"] = bool((S[~on] == 0).all())
print("MESH_RESULT " + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""

# 9b's injected OOM: the stage-1 dispatch and both of its lane splits
# (max_retries = 2) fail, so the ladder drops the mesh and the round runs
# single-device on each rank
MESH_DROP_RULE = dict(site="dispatch", where={"stage": 1}, times=3)


def dense_check(torch, tk, S, A, where: str) -> None:
    """S of a dense-support route against B2's on the same adjacency:
    equal on every edge, zero off the edges."""
    on = A > 0
    want = tk.triangle_count(A.to(torch.uint8), symmetric=True)
    if not torch.equal(S[on].int(), want[on]) or bool((S[~on] != 0).any()):
        raise AssertionError(f"{where}: S differs from B2's")


def mesh_one_rank(torch, dist, D, tk, truss_decompose, truss_maintain,
                  estimate_working_set, build_graph, rmat, run_phase,
                  phase_launches, n15, e15, budget, phi15, phi15_in,
                  n_er, e_er, dev) -> dict:
    """Phases 9a and 9c on a one-rank NCCL mesh in this process (a
    ``HashStore``, no network): bottom-up on phase 4's graph and budget,
    budgeted top-down on 5f's graph over a (1, 1) ("data", "tri") mesh,
    8a's 64 edits, then the two dense supports on 5b's ER core.  Every
    collective runs at this mesh size too."""
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("nccl", store=dist.HashStore(), rank=0,
                            world_size=1)
    try:
        data = init_device_mesh("cuda", (1,), mesh_dim_names=("data",))
        data_tri = init_device_mesh("cuda", (1, 1),
                                    mesh_dim_names=("data", "tri"))
        c0 = D.COLLECTIVES
        tag = "9a mesh bottom-up rmat15"
        phi, st = run_phase(tag, lambda: truss_decompose(
            n15, e15, engine="bottom-up", memory_budget=budget, mesh=data,
            with_stats=True, device=dev))
        out = dict(bottom_up=dict(
            devices=st.devices, sharded_rounds=st.sharded_rounds,
            rounds=st.rounds, padding_waste=round(st.padding_waste, 4),
            collectives=D.COLLECTIVES - c0,
            launches=phase_launches[tag]["B1"]))
        say(f"[9a] {out['bottom_up']}; OocStats {st}")
        if not np.array_equal(phi, phi15):
            raise AssertionError("9a: the mesh bottom-up phi differs from "
                                 "phase 4a's")
        check_digest("rmat15", phi)
        if (st.devices, st.sharded_rounds > 0,
                out["bottom_up"]["launches"] > 0) != (1, True, True):
            raise AssertionError(f"9a: {out['bottom_up']}")
        n13, e13 = rmat(13, 8, seed=5)
        b13 = estimate_working_set(build_graph(n13, e13)) // 16
        c0 = D.COLLECTIVES
        tag = "9a mesh budgeted top-down rmat13"
        phi, st = run_phase(tag, lambda: truss_decompose(
            n13, e13, engine="top-down", memory_budget=b13, mesh=data_tri,
            mesh_axes=("data", "tri"), with_stats=True, device=dev))
        out["top_down"] = dict(devices=st.devices,
                               sharded_rounds=st.sharded_rounds,
                               collectives=D.COLLECTIVES - c0,
                               launches=phase_launches[tag]["B1"])
        say(f"[9a] top-down {out['top_down']}")
        check_digest("rmat13", phi)
        if st.sharded_rounds == 0 or out["top_down"]["launches"] == 0:
            raise AssertionError(f"9a: top-down {out['top_down']}")
        c0 = D.COLLECTIVES
        tag = "9a mesh maintain b=64 rmat15"
        res = run_phase(tag, lambda: truss_maintain(
            (n15, e15), phi15_in, edit_batch(n15, e15, 64), mesh=data,
            device=dev))
        out["maintain"] = dict(collectives=D.COLLECTIVES - c0,
                               launches=phase_launches[tag]["B1"])
        check_maint("9a maintain b=64", res, MAINT_DIGESTS["8a_b64"])
        say(f"[9a] maintenance {out['maintain']}")
        # 9c: the dense supports on 5b's ER core, against B2
        A = torch.zeros((n_er, n_er), device=dev)
        er = torch.as_tensor(e_er, device=dev)
        A[er[:, 0], er[:, 1]] = A[er[:, 1], er[:, 0]] = 1
        for name, fn in (("ring", D.ring_support_dense),
                         ("allgather", D.allgather_support_dense)):
            c0 = D.COLLECTIVES
            S = run_phase(f"9c {name}_support_dense er2048",
                          lambda: fn(data, A))
            dense_check(torch, tk, S, A, f"9c {name} at one rank")
            out[f"{name}_collectives"] = D.COLLECTIVES - c0
        out["collectives"] = D.COLLECTIVES
        say(f"[9c] ring and allgather S equal B2's S on every edge of "
            f"er2048, zero off them; collective calls over 9a-9c "
            f"{D.COLLECTIVES}")
        if D.COLLECTIVES <= 0:
            raise AssertionError("9a-9c ran no collective")
        return out
    finally:
        dist.destroy_process_group()


def mesh_two_ranks(run_phase, timeout_s: int = 420) -> dict:
    """Phase 9b (and 9c at two ranks): two child processes, one gloo group
    on the one card, run ``MESH_CHILD``; both must end within ``timeout_s``
    (else both are killed and the phase fails), each phi must equal the
    rmat13 digest and the other rank's, the dispatches must span 2 devices
    with B1 launched on each rank, the injected plan must reach the
    mesh-drop rung, and both dense supports must equal B2's S."""
    want = DIGESTS["rmat13"]["sha256"]
    with tempfile.TemporaryDirectory(prefix="chip_smoke_mesh_") as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        procs = [subprocess.Popen(
            [sys.executable, "-c", MESH_CHILD, os.path.join(d, "rendezvous"),
             str(rank), json.dumps(MESH_DROP_RULE)], env=env,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
            for rank in (0, 1)]

        def wait():
            deadline = time.perf_counter() + timeout_s
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(
                        timeout=max(1.0, deadline - time.perf_counter())))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            return outs

        try:
            outs = run_phase("9b two ranks on one card rmat13", wait)
        except subprocess.TimeoutExpired:
            raise AssertionError(f"9b: the ranks did not finish within "
                                 f"{timeout_s} s (killed)")
    ranks = []
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        line = [ln for ln in so.splitlines() if ln.startswith("MESH_RESULT ")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"9b: rank {rank} exited {p.returncode}: "
                                 f"{so[-800:]} {se[-3000:]}")
        ranks.append(json.loads(line[-1].split(" ", 1)[1]))
        say(f"[9b] rank {rank}: {ranks[-1]}")
    for rank, res in enumerate(ranks):
        for tag in ("bottom-up", "top-down", "peel_classes_sharded",
                    "mesh-drop"):
            if res[tag]["sha256"] != want:
                raise AssertionError(f"9b: rank {rank}'s {tag} phi differs "
                                     f"from the rmat13 digest")
            if res[tag]["B1"] == 0:
                raise AssertionError(f"9b: rank {rank}'s {tag} never "
                                     f"launched B1")
        for tag in ("bottom-up", "top-down"):
            if res[tag]["devices"] != 2 or res[tag]["sharded_rounds"] == 0:
                raise AssertionError(f"9b: rank {rank}'s {tag}: "
                                     f"{res[tag]}")
        if res["mesh-drop"]["degraded"] < 1:
            raise AssertionError(f"9b: rank {rank}: the plan took no "
                                 f"mesh drop: {res['mesh-drop']}")
        for tag in ("ring_support_dense", "allgather_support_dense"):
            if not (res[tag]["equals_b2_on_edges"]
                    and res[tag]["zero_off_edges"]):
                raise AssertionError(f"9b: rank {rank}'s {tag} differs from "
                                     f"B2's S")
    keys = ("sha256", "devices", "sharded_rounds", "rounds", "retries",
            "degraded")
    for tag in ("bottom-up", "top-down", "mesh-drop"):
        a, b = ({k: r[tag][k] for k in keys} for r in ranks)
        if a != b:
            raise AssertionError(f"9b: the ranks disagree on {tag}: {a} {b}")
    return dict(ranks=ranks)


class RouteRecorder:
    """Wraps the transformer's ``moe_route`` as ``Probe`` wraps a kernel:
    keeps every call's ``Routing`` (``calls``), and the rows
    ``[::stride][:rows]`` of the first ``_moe_ffn`` call's input (layer 0
    of the first prefill; one copy, its only launch).  With ``replay`` (an
    earlier run's ``calls``), the n-th call returns the n-th of those
    instead of routing: the run takes that run's experts, slots and
    weights."""

    def __init__(self, lm, rows: int = 0, stride: int = 1, replay=None):
        self.lm, self.rows, self.stride = lm, rows, stride
        self.replay = replay
        self.route_fn, self.ffn_fn = lm.moe_route, lm._moe_ffn
        self.calls: list = []
        self.first_rows = None
        lm.moe_route, lm._moe_ffn = self._route, self._ffn

    def _route(self, xt, router, cfg):
        r = (self.route_fn(xt, router, cfg) if self.replay is None
             else self.replay[len(self.calls)])
        self.calls.append(r)
        return r

    def _ffn(self, x, lp, cfg):
        if self.rows and self.first_rows is None:
            self.first_rows = x.reshape(-1, x.shape[-1])[
                ::self.stride][:self.rows].clone()
        return self.ffn_fn(x, lp, cfg)

    def close(self) -> None:
        self.lm.moe_route, self.lm._moe_ffn = self.route_fn, self.ffn_fn


def spread(xs) -> dict:
    return dict(min=min(xs), median=float(np.median(xs)), max=max(xs))


def routing_diff(torch, a, b, n_req: int, K: int) -> dict:
    """Two prefills' routings, layer by layer: the slots kept in either run
    whose expert or kept flag differs (per layer), the (token, layer) pairs
    whose experts or kept flags differ (per request), and the requests whose
    last token differs in some layer."""
    kept, per_req, last = [], 0, 0
    for r1, r2 in zip(a, b):
        d = (r1.tope.reshape(-1) != r2.tope.reshape(-1)) | (r1.keep
                                                            != r2.keep)
        kept.append(((r1.keep | r2.keep) & d).sum())
        tok = d.view(-1, K).any(1).view(n_req, -1)
        per_req = per_req + tok.sum(1)
        last = last + tok[:, -1].long()
    return dict(kept_slots_differ=torch.stack(kept).tolist(),
                token_layers_differ=per_req.tolist(),
                last_token_differs=[bool(x) for x in last.tolist()])


def decode_bound_ms(cfg, params, calls, n_req: int, steps: int,
                    prompt_len: int) -> dict:
    """Least time of one decode step, bytes over the memory rate: every
    parameter but the embedding (n_req rows of it), and the cache's keys and
    values up to the step's position (the mean over the steps).  ``all``:
    every expert read, as the batched expert products over E do; ``kept``:
    only the experts that kept a slot in that step (``calls``: the decode
    steps' routing records)."""
    L, d, fe = cfg.n_layers, cfg.d_model, cfg.d_ff_expert
    isz = 2                                      # bf16
    leaves = [a for k, a in params.items() if k not in ("layers", "embed")]
    leaves += list(params["layers"].values())
    weights = sum(a.numel() * a.element_size() for a in leaves) \
        + n_req * d * isz
    pos = prompt_len + (steps + 1) / 2
    cache = 2 * L * n_req * pos * cfg.n_kv * cfg.d_head * isz
    expert = 3 * d * fe * isz
    kept = sum(int(r.keep.sum()) for r in calls) / steps    # experts used
    unused = L * cfg.n_experts - kept
    return dict(all=(weights + cache) / HBM_BYTES_PER_S * 1e3,
                kept=(weights + cache - unused * expert)
                / HBM_BYTES_PER_S * 1e3,
                weight_bytes=weights, cache_bytes=cache,
                experts_kept_per_step=kept)


def moe_serve(torch, lm, serve, cfg, tag: str, run_phase, zero_counts,
              phase_launches, ak, dev, keep_layer0: bool = False):
    """Phases 7b and 7c: ``cfg`` served at full width through
    ``serve.generate`` with the flash kernel on (phase 7's traffic), then a
    prefill on the plain attention path.  Checks the parameter count, B3
    once per layer and nothing else launched, finite logits of the right
    shapes, and the two prefills' last-token logits within MOE_LOGITS_TOL on
    the requests whose routing agreed in every layer; prints the slots
    dropped by layer and the routing differences.  Returns (summary, the B3
    probe of the serve, and with ``keep_layer0`` (MOE_ROWS rows of the layer-0
    FFN input, that layer's FFN weights on the host))."""
    from repro_torch.kernels.decode_attention import kernel as dk

    t_phase = time.perf_counter()
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    leaves = [a for k, a in params.items() if k != "layers"]
    leaves += list(params["layers"].values())
    n_params = sum(a.numel() for a in leaves)
    if n_params != cfg.param_count():
        raise AssertionError(f"{tag}: {n_params} parameters, config says "
                             f"{cfg.param_count()}")
    gib = sum(a.numel() * a.element_size() for a in leaves) / 2 ** 30
    say(f"[{tag}] {cfg.name}: {cfg.n_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.n_q}/{cfg.n_kv} heads of {cfg.d_head}, {cfg.n_experts} "
        f"experts of {cfg.d_ff_expert}, top {cfg.top_k} + "
        f"{cfg.n_shared_experts} shared, vocab {cfg.vocab}: {n_params:,} "
        f"parameters, {gib:.2f} GiB (bf16, the router float32), initialised "
        f"on the card in {init_s:.2f} s")
    n_req, prompt_len, new_tokens, max_seq = LM_TRAFFIC
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (n_req, prompt_len)).astype(np.int32)
    probe = Probe(torch, ak, "flash_attention",
                  size=lambda q, k, v, causal, window: q.numel() *
                  visible_pairs(q.shape[2], window),
                  bound=lambda q, k, v, causal, window: b3_bound(q, k,
                                                                 window)[0])
    rec = RouteRecorder(lm, MOE_ROWS, n_req * prompt_len // MOE_ROWS)
    serve_tag = f"{tag} serve {cfg.name}"
    zero_counts()
    gen = run_phase(serve_tag, lambda: serve.generate(
        params, prompts, cfg, new_tokens, max_seq, device=dev))
    peak = torch.cuda.max_memory_allocated()
    rec.close()
    b3_ms = probe.close()
    launches = phase_launches[serve_tag]
    b5_want = b5_launches(dk, cfg, n_req, max_seq, new_tokens)
    if launches["B3"] != cfg.n_layers or len(probe.events) != cfg.n_layers \
            or launches["B5"] != b5_want \
            or any(launches[k] for k in ("B1", "B2", "B4")):
        raise AssertionError(f"{tag}: launches {launches}; B3 must launch "
                             f"once in each of {cfg.n_layers} layers, B5 "
                             f"{b5_want} times in {new_tokens} decode steps, "
                             f"and nothing else")
    flash = gen.prefill_logits.float()
    if gen.tokens.shape != (n_req, new_tokens) or \
            flash.shape != (n_req, cfg.vocab) or \
            gen.logits.shape != (n_req, cfg.vocab) or \
            not bool(torch.isfinite(flash).all()) or \
            not bool(torch.isfinite(gen.logits.float()).all()):
        raise AssertionError(f"{tag}: output of the wrong shape or not "
                             f"finite")
    L = cfg.n_layers
    if len(rec.calls) != L * (1 + new_tokens):
        raise AssertionError(f"{tag}: {len(rec.calls)} routing calls, not "
                             f"{L * (1 + new_tokens)}")
    drop = torch.stack([1 - r.keep.float().mean()
                        for r in rec.calls]).tolist()
    bound = decode_bound_ms(cfg, params, rec.calls[L:], n_req, new_tokens,
                            prompt_len)
    out = dict(
        params=n_params, gib=gib, init_s=init_s,
        prefill_ms=gen.prefill_s * 1e3,
        decode_step_ms=gen.decode_s * 1e3 / new_tokens,
        decode_tokens_per_s=n_req * new_tokens / gen.decode_s,
        decode_bound_ms=bound, peak_mib=peak / 2 ** 20,
        b3_launches=launches["B3"], b3_ms=b3_ms, b3_bound_ms=probe.bound_ms,
        b5_launches=launches["B5"],
        capacity=dict(prefill=rec.calls[0].capacity,
                      decode=rec.calls[L].capacity),
        dropped_prefill=spread(drop[:L]),
        dropped_decode_step1=spread(drop[L:2 * L]),
        dropped_decode=spread(drop[L:]))
    say(f"[{tag}] {n_req} requests x {prompt_len} prompt tokens: prefill "
        f"wall {out['prefill_ms']:.1f} ms; {new_tokens} decode steps "
        f"{out['decode_step_ms']:.2f} ms a step = "
        f"{out['decode_tokens_per_s']:.1f} tokens/s (a step's byte bound "
        f"{bound['all']:.2f} ms reading every expert, {bound['kept']:.2f} ms "
        f"reading the {bound['experts_kept_per_step']:.0f} experts that kept "
        f"a slot); peak device memory {out['peak_mib']:.1f} MiB; B3 "
        f"{launches['B3']} launches, {b3_ms:.3f} device ms in its calls "
        f"(summed bounds {probe.bound_ms:.3f} ms); B5 {launches['B5']} "
        f"launches; first request's tokens "
        f"{gen.tokens[0, :8].tolist()}...")
    say(f"[{tag}] capacity {out['capacity']}; share of slots dropped by "
        f"layer: prefill {out['dropped_prefill']}, first decode step "
        f"{out['dropped_decode_step1']}, all {new_tokens} decode steps "
        f"{out['dropped_decode']}")

    # the plain path twice: routing on its own values, then replaying the
    # flash prefill's routing, layer by layer
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    runs = {}
    for mode, replay in (("own", None), ("replayed", rec.calls[:L])):
        rec2 = RouteRecorder(lm, replay=replay)
        t0 = time.perf_counter()
        logits = lm.prefill(params, prompts, plain_cfg, max_seq=max_seq,
                            device=dev)[1].float()
        torch.cuda.synchronize()
        out[f"plain_prefill_{mode}_ms"] = (time.perf_counter() - t0) * 1e3
        rec2.close()
        runs[mode] = (logits, rec2.calls)
    plain, calls = runs["own"]
    rd = routing_diff(torch, rec.calls[:L], calls, n_req, cfg.top_k)
    agree = [n == 0 for n in rd["token_layers_differ"]]
    req_err = (flash - plain).abs().max(1).values.tolist()
    pinned = runs["replayed"][0]
    pinned_err = (flash - pinned).abs().max(1).values.tolist()
    held = torch.tensor(agree, device=flash.device)
    out.update(rd, requests_routing_differ=agree.count(False),
               logits_err_by_request=req_err,
               logits_err_routing_replayed=pinned_err,
               max_abs_plain=float(plain.abs().max()),
               logits_err_held=max((e for e, a in zip(req_err, agree) if a),
                                   default=None))
    say(f"[{tag}] plain-path prefill {out['plain_prefill_own_ms']:.1f} ms "
        f"({out['plain_prefill_replayed_ms']:.1f} ms replaying the routing); "
        f"kept slots whose routing differs from the flash prefill's, by "
        f"layer: {rd['kept_slots_differ']}; (token, layer) pairs that differ "
        f"by request: {rd['token_layers_differ']}; last token differs: "
        f"{rd['last_token_differs']}")
    say(f"[{tag}] last-token logits, max |plain| {out['max_abs_plain']:.4f}; "
        f"max |flash - plain| by request {[round(e, 4) for e in req_err]}, "
        f"{agree.count(True)} of {n_req} requests routed alike in every "
        f"layer and held; with the flash routing replayed "
        f"{[round(e, 4) for e in pinned_err]}, all held (tol "
        f"{MOE_LOGITS_TOL})")
    if not torch.allclose(flash[held], plain[held], **MOE_LOGITS_TOL):
        raise AssertionError(f"{tag}: the flash prefill's logits differ from "
                             f"the plain path's beyond MOE_LOGITS_TOL on a "
                             f"request routed alike")
    if not torch.allclose(flash, pinned, **MOE_LOGITS_TOL):
        raise AssertionError(f"{tag}: the flash prefill's logits differ from "
                             f"the plain path's under the same routing beyond "
                             f"MOE_LOGITS_TOL")
    layer0 = None
    if keep_layer0:
        layer0 = (rec.first_rows, {
            k: a[0].cpu() for k, a in params["layers"].items()
            if k in ("ln2", "router") or k.startswith(("we_", "ws_"))})
    del params, gen, flash, plain, pinned, runs, calls, rec, rec2
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"[{tag}] wall {out['wall_s']:.1f} s")
    return out, probe, layer0


def moe_layer_check(torch, lm, cfg, rows, lp_host, dev) -> dict:
    """Phase 7d: ``_moe_ffn`` of one full-width layer on the card and on
    the host, on ``rows`` (bf16) of 7b's layer-0 FFN input.  The experts,
    slots and kept flags must be equal, except for tokens whose router
    margin is below ROUTE_EPS (a changed expert set re-ranks the later slots
    of its experts, so slots are compared up to the first such token); the
    outputs of the tokens routed alike within MOE_FFN_TOL, aux within
    MOE_AUX_TOL."""
    t_phase = time.perf_counter()
    T, K = rows.shape[0], cfg.top_k
    lp_dev = {k: a.to(dev) for k, a in lp_host.items()}
    x_dev, x_host = rows[None], rows.cpu()[None]
    t0 = time.perf_counter()
    out_d, aux_d = lm._moe_ffn(x_dev, lp_dev, cfg)
    torch.cuda.synchronize()
    card_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    out_h, aux_h = lm._moe_ffn(x_host, lp_host, cfg)
    host_ms = (time.perf_counter() - t0) * 1e3

    def route(x, lp):
        xt = lm.cm.rms_norm(x, lp["ln2"], cfg.norm_eps).reshape(T, -1)
        return lm.moe_route(xt, lp["router"], cfg)

    rd, rh = route(x_dev, lp_dev), route(x_host, lp_host)
    top = rh.probs.sort(-1, descending=True).values[:, :K + 1]
    near = (top[:, :-1] - top[:, 1:]).min(-1).values < ROUTE_EPS
    tope_d = rd.tope.cpu()
    order_diff = (tope_d != rh.tope).any(1)
    if bool((order_diff & ~near).any()):
        raise AssertionError("7d: the card and the host route a token with a "
                             "router margin above ROUTE_EPS differently")
    (sd, od), (sh, oh) = tope_d.sort(1), rh.tope.sort(1)
    set_diff = (sd != sh).any(1)
    slot_d = rd.slot.cpu().view(T, K).gather(1, od)
    slot_h = rh.slot.view(T, K).gather(1, oh)
    keep_d = rd.keep.cpu().view(T, K).gather(1, od)
    keep_h = rh.keep.view(T, K).gather(1, oh)
    first = int(set_diff.nonzero()[0, 0]) if bool(set_diff.any()) else T
    if not (torch.equal(slot_d[:first], slot_h[:first])
            and torch.equal(keep_d[:first], keep_h[:first])):
        raise AssertionError("7d: slots or kept flags differ between the "
                             "card and the host")
    same = ~set_diff & (keep_d == keep_h).all(1)
    got, want = out_d[0].float().cpu()[same], out_h[0].float()[same]
    res = dict(
        rows=T, capacity=rd.capacity, dropped=int((~rh.keep).sum()),
        near_margin_rows=int(near.sum()), order_differs=int(order_diff.sum()),
        set_differs=int(set_diff.sum()), rows_compared=int(same.sum()),
        max_abs_probs_diff=float((rd.probs.cpu() - rh.probs).abs().max()),
        out_err=float((got - want).abs().max()),
        max_abs_out=float(want.abs().max()),
        aux_card=float(aux_d), aux_host=float(aux_h),
        card_ms=card_ms, host_ms=host_ms)
    say(f"[7d] one {cfg.name} layer on {T} rows of 7b's layer-0 FFN input "
        f"(bf16), card against host: {res}")
    if not torch.allclose(got, want, **MOE_FFN_TOL):
        raise AssertionError(f"7d: _moe_ffn's output differs between the card "
                             f"and the host beyond MOE_FFN_TOL (max abs err "
                             f"{res['out_err']})")
    if not np.isclose(res["aux_card"], res["aux_host"], **MOE_AUX_TOL):
        raise AssertionError("7d: aux differs between the card and the host")
    del lp_dev
    res["wall_s"] = time.perf_counter() - t_phase
    say(f"[7d] wall {res['wall_s']:.1f} s")
    return res


def grads_of(torch, tree, lm, cfg, params, batch, dev):
    """(total, loss, aux, gradient leaves) of ``lm.loss_fn``."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(params)]
    total, parts = lm.loss_fn(tree.unflatten_like(params, leaves), batch,
                              cfg, device=dev)
    grads = torch.autograd.grad(total, leaves)
    return (total.detach(), parts["loss"].detach(), parts["aux"].detach(),
            grads)


def max_err(torch, got, want) -> float:
    return max(float((g.cpu().float() - w.float()).abs().max())
               for g, w in zip(got, want))


def train_reduced_card_vs_host(torch, tree, lm, registry, make_reduced,
                               make_train_step, adamw, dev) -> dict:
    """10a, first part: every LM arch at ``reduced_lm`` (float32) from the
    same host parameters and TokenStream batch: loss, aux and every
    gradient, then one ``make_train_step(microbatches=2)`` step, on the card
    and on the host."""
    out = {}
    cpu = torch.device("cpu")
    for arch in registry.LM_ARCHS:
        cfg, init_fn, _, batch_fn = make_reduced(arch, device=cpu)
        host = init_fn()
        card = tree.map_leaves(lambda x: x.to(dev, copy=True), host)
        batch_h = batch_fn(0)
        batch_d = {k: v.to(dev) for k, v in batch_h.items()}
        rh = grads_of(torch, tree, lm, cfg, host, batch_h, cpu)
        rd = grads_of(torch, tree, lm, cfg, card, batch_d, dev)
        for name, a, b in (("loss", rd[1], rh[1]), ("aux", rd[2], rh[2])):
            if not np.isclose(float(a), float(b), **TRAIN_TOL):
                raise AssertionError(f"10a {arch}: {name} {float(a)} on the "
                                     f"card, {float(b)} on the host")
        for path, g, w in zip(tree.flatten_with_paths(host)[0], rd[3],
                              rh[3]):
            if not torch.allclose(g.cpu(), w, **TRAIN_TOL):
                raise AssertionError(f"10a {arch}: the gradient of {path} "
                                     f"differs between the card and the host")
        ocfg = adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1, total_steps=10)
        (pd, sd, md), (ph, sh, mh) = (
            make_train_step(lambda p, b, w=where: lm.loss_fn(
                p, b, cfg, device=w)[0], ocfg, microbatches=2)(
                    params, adamw.init_state(params), batch)
            for where, params, batch in ((dev, card, batch_d),
                                         (cpu, host, batch_h)))
        for k in ("loss", "grad_norm", "lr"):
            if not np.isclose(float(md[k]), float(mh[k]), **TRAIN_TOL):
                raise AssertionError(f"10a {arch}: the train step's {k} "
                                     f"differs between the card and the host")
        for k in ("m", "v"):
            if not all(torch.allclose(a.cpu(), b, **TRAIN_TOL) for a, b in
                       zip(tree.leaves(sd[k]), tree.leaves(sh[k]))):
                raise AssertionError(f"10a {arch}: the train step's {k} "
                                     f"differs between the card and the host")
        if not all(torch.allclose(a.cpu(), b, **TRAIN_STEP_TOL) for a, b in
                   zip(tree.leaves(pd), tree.leaves(ph))):
            raise AssertionError(f"10a {arch}: the train step's parameters "
                                 f"differ between the card and the host")
        out[arch] = dict(loss=float(rd[1]), aux=float(rd[2]),
                         loss_err=abs(float(rd[1]) - float(rh[1])),
                         grad_err=max_err(torch, rd[3], rh[3]),
                         step_loss=float(md["loss"]),
                         step_param_err=max_err(torch, tree.leaves(pd),
                                                tree.leaves(ph)))
    return out


def train_loop_run(torch, tree, make_reduced, make_train_step, adamw,
                   train_loop, dev, ckpt_dir, fault_step=None):
    """``train_loop.run`` on qwen2.5-14b's reduced config on the card,
    TRAIN_LOOP_STEPS steps at TRAIN_LR (the training CLI's schedule), a
    checkpoint every TRAIN_CKPT_EVERY steps; with ``fault_step``, a
    RuntimeError raised once before that step."""
    cfg, init_fn, loss_fn, batch_fn = make_reduced("qwen2.5-14b", device=dev)
    step = make_train_step(loss_fn, adamw.AdamWConfig(
        lr=TRAIN_LR, warmup_steps=max(TRAIN_LOOP_STEPS // 20, 1),
        total_steps=TRAIN_LOOP_STEPS))
    fired = []

    def fault_hook(i):
        if i == fault_step and not fired:
            fired.append(i)
            raise RuntimeError(f"injected fault at step {i}")

    def init_state():
        params = init_fn()
        return {"params": params, "opt": adamw.init_state(params)}

    def train_step(state, batch):
        params, opt, m = step(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, m

    return train_loop.run(train_loop.LoopConfig(
        steps=TRAIN_LOOP_STEPS, ckpt_dir=ckpt_dir,
        ckpt_every=TRAIN_CKPT_EVERY, log_every=1), init_state, train_step,
        batch_fn, fault_hook=fault_hook)


def layer_card_vs_host(torch, lm, registry, dev) -> dict:
    """10b: one gemma3-4b global layer (LAYER_INDEX) at full width,
    ``x + attn + ffn`` on (1, LAYER_TOKENS) tokens in float32 on the card
    and on the host: the gradients of every layer weight (and of x) of
    ``sum(out * cotangent)`` within LAYER_GRAD_RTOL of each one's largest
    magnitude.  Weights and inputs from a host generator seeded with 0."""
    cfg = dataclasses.replace(registry.get_config("gemma3-4b"),
                              param_dtype=torch.float32,
                              compute_dtype=torch.float32, remat=False)
    kind = lm._kind(cfg, LAYER_INDEX)
    if kind != "global":
        raise AssertionError(f"10b: layer {LAYER_INDEX} is {kind}")
    gen = torch.Generator().manual_seed(0)
    d, dh, f = cfg.d_model, cfg.d_head, cfg.d_ff
    shapes = dict(wq=(d, cfg.n_q * dh), wk=(d, cfg.n_kv * dh),
                  wv=(d, cfg.n_kv * dh), wo=(cfg.n_q * dh, d),
                  w_gate=(d, f), w_up=(d, f), w_down=(f, d))
    host = {k: lm.cm.dense_init(gen, s) for k, s in shapes.items()}
    for k in ("ln1", "ln2"):
        host[k] = 0.1 * torch.randn(d, generator=gen)
    host["x"] = torch.randn((1, LAYER_TOKENS, d), generator=gen)
    cot = torch.randn((1, LAYER_TOKENS, d), generator=gen)
    pos = torch.arange(LAYER_TOKENS, dtype=torch.int32)[None]
    res = []
    for where in (dev, torch.device("cpu")):
        leaves = {k: a.to(where).requires_grad_(True)
                  for k, a in host.items()}
        lp = {k: a for k, a in leaves.items() if k != "x"}
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out, _ = lm._layer_fwd(leaves["x"], lp, kind, pos.to(where), cfg)
        grads = torch.autograd.grad((out * cot.to(where)).sum(),
                                    list(leaves.values()))
        torch.cuda.synchronize()
        res.append((dict(zip(leaves, grads)),
                    (time.perf_counter() - t0) * 1e3, out))
    (gd, card_ms, od), (gh, host_ms, oh) = res
    rel = {k: float((gd[k].cpu() - gh[k]).abs().max() / gh[k].abs().max())
           for k in gh}
    out_rel = float((od.detach().cpu() - oh.detach()).abs().max()
                    / oh.detach().abs().max())
    bad = [k for k, r in rel.items() if not r <= LAYER_GRAD_RTOL]
    r = dict(layer=LAYER_INDEX, kind=kind, tokens=LAYER_TOKENS,
             grad_rel_err=rel, out_rel_err=out_rel, card_ms=card_ms,
             host_ms=host_ms)
    say(f"[10b] gemma3-4b layer {LAYER_INDEX} ({kind}) at full width, "
        f"float32, {LAYER_TOKENS} tokens, card against host: {r}")
    if bad or not out_rel <= LAYER_GRAD_RTOL:
        raise AssertionError(f"10b: the gradients of {bad} (or the output) "
                             f"differ between the card and the host beyond "
                             f"LAYER_GRAD_RTOL")
    return r


def train_full_width(torch, tree, lm, registry, TokenStream, adamw, cells,
                     run_phase, phase_launches, dev) -> dict:
    """10c: gemma3-4b trained at full width (bf16, remat "full", random
    weights from a generator seeded with 0): TRAIN_STEPS steps of
    ``make_train_step(microbatches=1)`` on one TokenStream sequence of
    TRAIN_SEQ tokens, the same batch each step, lr 1e-3 after one warmup
    step.  ``adamw.update`` is wrapped to time it; its own peak is read on
    one more update, with zero gradients, after the timed steps."""
    from repro_torch.configs import lm_family

    cfg = registry.get_config("gemma3-4b")
    n = cfg.param_count()
    state_gib = 16 * n / 2 ** 30
    logits_gib = TRAIN_SEQ * cfg.vocab * 2 / 2 ** 30
    say(f"[10c] {cfg.name}: {n:,} parameters; weights, gradients (bf16) "
        f"and float32 master, m, v: {state_gib:.1f} GiB; the loss head's "
        f"bf16 logits {logits_gib:.1f} GiB and their float32 copy "
        f"{2 * logits_gib:.1f} GiB, about as much again in the backward; "
        f"held now {torch.cuda.memory_allocated() / 2 ** 30:.2f} GiB")
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    params = lm.init_params(torch.Generator(device=dev).manual_seed(0), cfg)
    opt = adamw.init_state(params)
    torch.cuda.synchronize()
    init_s = time.perf_counter() - t0
    largest = max(a.numel() for a in tree.leaves(params))
    stream = TokenStream(cfg.vocab, seq_len=TRAIN_SEQ, global_batch=1, seed=0)
    batch = {k: torch.as_tensor(v, device=dev)
             for k, v in stream.batch(0).items()}
    step = cells.make_train_step(
        lambda p, b: lm.loss_fn(p, b, cfg, device=dev)[0],
        adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1), microbatches=1)
    update, upd = adamw.update, []

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - t)
        return out

    flops = 6 * n * TRAIN_SEQ + 3 * lm_family._attn_fwd_flops(cfg, 1,
                                                                TRAIN_SEQ)
    bound_s = flops / BF16_FLOPS_PER_S
    rows = []

    def run_steps():
        nonlocal params, opt
        for i in range(TRAIN_STEPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(params, opt, batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            rows.append(dict(
                step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                lr=float(m["lr"]), wall_s=wall, fwd_bwd_s=wall - upd[-1],
                adamw_s=upd[-1], adamw_share=upd[-1] / wall,
                tokens_per_s=TRAIN_SEQ / wall,
                train_mfu=flops / wall / BF16_FLOPS_PER_S,
                peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20))
            say(f"[10c] step {i}: {rows[-1]}")

    adamw.update = timed_update
    try:
        run_phase("10c train gemma3-4b", run_steps)
    finally:
        adamw.update = update
    losses = [r["loss"] for r in rows]
    if not all(np.isfinite([r["loss"] for r in rows] +
                           [r["grad_norm"] for r in rows])):
        raise AssertionError(f"10c: a loss or grad_norm is not finite: {rows}")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"10c: the loss did not fall: {losses}")
    if any(phase_launches["10c train gemma3-4b"].values()):
        raise AssertionError(f"10c: a kernel launched in training: "
                             f"{phase_launches['10c train gemma3-4b']}")
    # AdamW's own peak above what it finds held, on one more update with
    # zero gradients: at most two float32 temporaries of the largest leaf,
    # and the step's small tensors
    zeros = tree.map_leaves(torch.zeros_like, params)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    update(adamw.AdamWConfig(lr=TRAIN_LR, warmup_steps=1), params, opt,
           zeros)
    torch.cuda.synchronize()
    extra = torch.cuda.max_memory_allocated() - held
    del zeros
    if extra > 2 * 4 * largest + 2 ** 26:
        raise AssertionError(f"10c: AdamW took {extra / 2**20:.1f} MiB above "
                             f"its start, more than two float32 copies of the "
                             f"largest leaf ({largest:,} elements)")
    flash = lambda p, b: lm.loss_fn(p, b, dataclasses.replace(
        cfg, use_flash_kernel=True), device=dev)[0]
    try:
        cells.value_and_grad(flash, params, batch)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("10c: use_flash_kernel=True under a gradient "
                             "did not raise")
    del params, opt, batch
    torch.cuda.empty_cache()
    res = dict(
        arch=cfg.name, n_layers=cfg.n_layers, d_model=cfg.d_model,
        vocab=cfg.vocab, params=n, tokens=TRAIN_SEQ, init_s=init_s,
        model_flops=flops, bound_ms=bound_s * 1e3, state_gib=state_gib,
        largest_leaf=largest, adamw_extra_mib=extra / 2 ** 20, steps=rows,
        flash_refused=refused[:60],
        b3_launches=phase_launches["10c train gemma3-4b"]["B3"])
    say(f"[10c] {cfg.name} at full width ({cfg.n_layers} layers, d_model "
        f"{cfg.d_model}, vocab {cfg.vocab}), {TRAIN_SEQ} tokens a step: init "
        f"{init_s:.2f} s; losses {losses}; step wall "
        f"{[round(r['wall_s'], 4) for r in rows]} s against a bound of "
        f"{bound_s * 1e3:.1f} ms ({flops:.4g} flops over 989 TFLOP/s); "
        f"tokens/s {rows[-1]['tokens_per_s']:.1f}, train_mfu "
        f"{rows[-1]['train_mfu']:.4f}, AdamW share "
        f"{rows[-1]['adamw_share']:.4f} (its own peak {extra / 2**20:.1f} MiB "
        f"above what it found held), peak "
        f"{max(r['peak_mib'] for r in rows):.1f} MiB; B3 launches "
        f"{res['b3_launches']}; the flash kernel under a gradient raised")
    return res


def train_phases(torch, run_phase, phase_launches, dev) -> dict:
    """Phase 10: training, after every LM parameter of phases 7-7d is
    freed."""
    from repro_torch import tree
    from repro_torch.configs import cells, registry
    from repro_torch.configs.reduced import make_reduced
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as lm
    from repro_torch.optim import adamw
    from repro_torch.runtime import train_loop

    t_phase = time.perf_counter()
    say(f"[10] training; held at its start "
        f"{torch.cuda.memory_allocated() / 2 ** 20:.1f} MiB")
    out = {"10a": run_phase("10a reduced archs card against host",
                            lambda: train_reduced_card_vs_host(
                                torch, tree, lm, registry, make_reduced,
                                cells.make_train_step, adamw, dev))}
    say(f"[10a] card against host: {json.dumps(out['10a'])}")
    runs = {}
    with tempfile.TemporaryDirectory(prefix="train-smoke-") as tmp:
        for name, fault in (("clean", None), ("fault", TRAIN_FAULT_STEP)):
            runs[name] = run_phase(
                f"10a train loop qwen2.5-14b ({name})",
                lambda: train_loop_run(
                    torch, tree, make_reduced, cells.make_train_step, adamw,
                    train_loop, dev, os.path.join(tmp, name), fault))[1]
    losses = {name: {r["step"]: r["loss"] for r in rows if "loss" in r}
              for name, rows in runs.items()}
    clean = [losses["clean"][i] for i in range(TRAIN_LOOP_STEPS)]
    restarts = [r for r in runs["fault"] if "restart" in r]
    out["loop"] = dict(first=clean[0], last5_mean=float(np.mean(clean[-5:])),
                       losses=clean, restarts=restarts,
                       resumed_equal=losses["fault"] == losses["clean"])
    say(f"[10a] train loop qwen2.5-14b reduced, {TRAIN_LOOP_STEPS} steps: "
        f"loss {clean[0]:.4f} -> mean of the last 5 "
        f"{out['loop']['last5_mean']:.4f}; fault at step {TRAIN_FAULT_STEP}: "
        f"{restarts}, replayed losses equal: {out['loop']['resumed_equal']}")
    if not out["loop"]["last5_mean"] < clean[0]:
        raise AssertionError("10a: the reduced training loss did not fall")
    if len(restarts) != 1 or not out["loop"]["resumed_equal"]:
        raise AssertionError("10a: the resumed run's losses differ from the "
                             "uninterrupted run's")
    out["10b"] = run_phase("10b gemma3-4b layer card against host",
                           lambda: layer_card_vs_host(torch, lm, registry,
                                                      dev))
    out["10c"] = train_full_width(torch, tree, lm, registry, TokenStream,
                                  adamw, cells, run_phase, phase_launches,
                                  dev)
    launched = {t: c for t, c in phase_launches.items()
                if t.startswith("10") and any(c.values())}
    if launched:
        raise AssertionError(f"10: a kernel launched in training: {launched}")
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"[10] wall {out['wall_s']:.1f} s")
    return out


def wall_s(torch, fn, reps: int = 3) -> float:
    """Host wall of one ``fn()`` that ends in a device synchronisation,
    the best of ``reps`` after one warm-up call."""
    fn()
    best = float("inf")
    for _ in range(reps):
        torch.cuda.synchronize()
        t = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        best = min(best, time.perf_counter() - t)
    return best


def to_device(torch, arrays: dict, dev) -> dict:
    return {k: torch.as_tensor(v, device=dev) for k, v in arrays.items()}


def timed_steps(torch, adamw, step, state, batch, n_steps: int, tag: str,
                run_phase, flops: float = 0.0, items: int = 0) -> list:
    """``n_steps`` calls of a ``make_train_step`` step on one batch under
    ``run_phase(tag)``, ``adamw.update`` timed inside each: per step the
    loss, grad_norm, wall, AdamW share, items/s, the step's flops over the
    wall against FP32_FLOPS_PER_S and the peak device memory."""
    update, upd, rows = adamw.update, [], []

    def timed_update(*args, **kw):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = update(*args, **kw)
        torch.cuda.synchronize()
        upd.append(time.perf_counter() - t)
        return out

    def run():
        for i in range(n_steps):
            torch.cuda.synchronize()
            t = time.perf_counter()
            params, opt, m = step(state["params"], state["opt"], batch)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            state.update(params=params, opt=opt)
            rows.append(dict(
                step=i, loss=float(m["loss"]), grad_norm=float(m["grad_norm"]),
                wall_s=wall, adamw_s=upd[-1], adamw_share=upd[-1] / wall,
                items_per_s=items / wall, flops_per_s=flops / wall,
                fp32_share=flops / wall / FP32_FLOPS_PER_S,
                peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20))
            say(f"[{tag}] step {i}: {rows[-1]}")

    adamw.update = timed_update
    try:
        run_phase(tag, run)
    finally:
        adamw.update = update
    if not np.all(np.isfinite([r["loss"] for r in rows]
                              + [r["grad_norm"] for r in rows])):
        raise AssertionError(f"{tag}: a loss or grad_norm is not finite: "
                             f"{rows}")
    return rows


def summary(rows: list) -> str:
    """One line of timed_steps' rows: losses, walls, the last step's rates
    and shares, the peak."""
    last = rows[-1]
    return (f"losses {[round(r['loss'], 5) for r in rows]}, step walls "
            f"{[round(r['wall_s'], 4) for r in rows]} s, "
            f"{last['items_per_s']:.1f} items/s, "
            f"{last['flops_per_s'] / 1e12:.3f} TFLOP/s (fp32 share "
            f"{last['fp32_share']:.4f}), AdamW share "
            f"{last['adamw_share']:.4f}, peak "
            f"{max(r['peak_mib'] for r in rows):.1f} MiB")


def din_phases(torch, run_phase, phase_launches, bk, bref, dev) -> dict:
    """Phase 11: DIN at full width (configs/din.py; random weights from a
    generator seeded with 0 on the card, batches from RecsysStream seed 0).
    Returns the results and, under "b4", B4 on its DIN path: each of
    11b's four calls (the hist and cand lookups on both tables, bags of one
    row) checked against its plain version and timed beside its bound and
    ``torch.index_select`` on the same ids."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.configs import cells, registry
    from repro_torch.configs import recsys_family as fam
    from repro_torch.core import distributed as D
    from repro_torch.data.recsys_stream import RecsysStream
    from repro_torch.models.recsys import din as DIN
    from repro_torch.models.recsys import embedding as emb
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    cfg = registry.get_config("din")
    n = cfg.param_count()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    params = DIN.din_init(torch.Generator(device=dev).manual_seed(0), cfg)
    torch.cuda.synchronize()
    out = dict(params=n, init_s=time.perf_counter() - t0,
               param_mb=4 * n / 1e6)
    if sum(a.numel() for a in tree.leaves(params)) != n:
        raise AssertionError("11: din_init's parameters differ from "
                             "param_count()")
    say(f"[11] din at full width: {n:,} parameters ({out['param_mb']:.1f} "
        f"MB float32), init {out['init_s']:.3f} s")

    def batch(b, step):
        return RecsysStream(cfg.n_items, cfg.n_cats, cfg.seq_len, b,
                            seed=0).batch(step)

    def b4_count(tag):
        return phase_launches[tag]["B4"]

    # 11a serve_p99: the B4 route on the card against the host's take
    bh = batch(fam.SHAPES["serve_p99"]["batch"], 0)
    bd = to_device(torch, bh, dev)
    host = tree.map_leaves(lambda a: a.cpu(), params)
    with torch.no_grad():
        tag = "11a din serve_p99 (B4)"
        card = run_phase(tag, lambda: DIN.din_scores(params, bd, cfg))
        take = DIN.din_scores(params, bd, cfg, kernel="take")
        want = DIN.din_scores(host, to_device(torch, bh, "cpu"), cfg)
        err = float((card.cpu() - want).abs().max())
        out["11a"] = dict(
            batch=len(card), b4_launches=b4_count(tag),
            equal_to_take=bool(torch.equal(card, take)), host_err=err,
            score_absmax=float(want.abs().max()),
            wall_s={k: wall_s(torch, lambda: DIN.din_scores(
                params, bd, cfg, kernel=k)) for k in ("bag", "take")})
    del host
    say(f"[11a] {out['11a']}")
    if out["11a"]["b4_launches"] != 4 or not out["11a"]["equal_to_take"]:
        raise AssertionError(f"11a: {out['11a']}")
    if not torch.allclose(card.cpu(), want, **DIN_TOL):
        raise AssertionError(f"11a: the card's scores differ from the "
                             f"host's by {err} (DIN_TOL {DIN_TOL})")

    # 11b serve_bulk: both routes on the card, B4's four calls probed
    bd = to_device(torch, batch(fam.SHAPES["serve_bulk"]["batch"], 1), dev)
    # the four calls differ in (V, bags), so all four are kept; their bound
    # (a sort of the ids) is summed after the path, not inside its wall
    probe = Probe(torch, bk, "embedding_bag",
                  size=lambda t, i, **kw: i.numel(),
                  bound=lambda *a, **kw: 0.0,
                  group=lambda t, i, **kw: (t.shape[0], i.shape[0]))
    try:
        with torch.no_grad():
            tag = "11b din serve_bulk (B4)"
            bag = run_phase(tag, lambda: DIN.din_scores(params, bd, cfg))
            bag_peak = torch.cuda.max_memory_allocated() / 2 ** 20
    finally:
        b4_path_ms = probe.close()
    with torch.no_grad():
        tag_t = "11b din serve_bulk (take)"
        take = run_phase(tag_t, lambda: DIN.din_scores(params, bd, cfg,
                                                       kernel="take"))
        take_peak = torch.cuda.max_memory_allocated() / 2 ** 20
        out["11b"] = dict(
            batch=len(bag), b4_launches=b4_count(tag),
            take_launches=b4_count(tag_t),
            equal_to_take=bool(torch.equal(bag, take)),
            peak_mib={"bag": bag_peak, "take": take_peak},
            wall_s={k: wall_s(torch, lambda: DIN.din_scores(
                params, bd, cfg, kernel=k)) for k in ("bag", "take")},
            b4_event_ms=b4_path_ms)
    del bag, take
    calls = []
    for (V, N), ((table, idx), _) in sorted(probe.largest.items(),
                                            key=lambda kv: -kv[0][1]):
        err = check_b4(torch, bk, bref, table, idx, "sum",
                       f"on DIN's path V={V} bags={N}")
        ids = idx.reshape(-1).long()
        calls.append(dict(
            V=V, bags=N, L=idx.shape[1], entry=bk.entry(idx.shape[1]),
            max_abs_err=err,
            ms=time_ms(torch, lambda: bk.embedding_bag(table, idx,
                                                       mode="sum"), 20),
            plain_ms=time_ms(torch, lambda: bref.embedding_bag(
                table, idx, mode="sum"), 5),
            library_ms=time_ms(torch, lambda: torch.index_select(
                table, 0, ids), 20),
            bound_ms=b4_bound_ms(table, idx)))
        say(f"[11b] B4 on DIN's path, V={V:,} D={table.shape[1]} "
            f"{N:,} bags of 1 (sum): {calls[-1]}")
    del probe
    out["11b"]["b4_calls"] = calls
    if len(calls) != out["11b"]["b4_launches"]:
        raise AssertionError(f"11b: {len(calls)} B4 calls kept of "
                             f"{out['11b']['b4_launches']}")
    for k in ("ms", "plain_ms", "library_ms", "bound_ms"):
        out["11b"][f"b4_sum_{k}"] = sum(c[k] for c in calls)
    out["11b"]["b4_bound_ms"] = out["11b"]["b4_sum_bound_ms"]
    say(f"[11b] {out['11b']}")
    if out["11b"]["b4_launches"] != 4 or out["11b"]["take_launches"] != 0 \
            or not out["11b"]["equal_to_take"]:
        raise AssertionError(f"11b: {out['11b']}")

    # 11c retrieval_cand: 1 user x 1,000,000 candidates in 50 chunks
    cfg_r = dataclasses.replace(cfg, cand_chunks=fam.RETRIEVAL_CHUNKS)
    n_cand = fam.SHAPES["retrieval_cand"]["n_candidates"]
    rb = to_device(torch, RecsysStream(
        cfg.n_items, cfg.n_cats, cfg.seq_len, 1, seed=0).retrieval_batch(
            n_cand, seed=0), dev)
    with torch.no_grad():
        tag = "11c din retrieval_cand (B4)"
        scores = run_phase(tag, lambda: DIN.din_retrieval(params, rb, cfg_r))
        sel = torch.arange(0, n_cand, n_cand // DIN_RETRIEVAL_CHECK,
                           device=dev)[:DIN_RETRIEVAL_CHECK]
        k = len(sel)
        pairs = {"hist_items": rb["hist_items"].expand(k, -1),
                 "hist_cats": rb["hist_cats"].expand(k, -1),
                 "hist_mask": rb["hist_mask"].expand(k, -1),
                 "cand_item": rb["cand_items"][sel],
                 "cand_cat": rb["cand_cats"][sel]}
        want = DIN.din_scores(params, pairs, cfg)
        out["11c"] = dict(
            candidates=len(scores), chunks=cfg_r.cand_chunks,
            b4_launches=b4_count(tag), finite=bool(torch.isfinite(
                scores).all()),
            pair_err=float((scores[sel] - want).abs().max()),
            wall_s=wall_s(torch, lambda: DIN.din_retrieval(params, rb,
                                                           cfg_r), 2),
            peak_mib=torch.cuda.max_memory_allocated() / 2 ** 20)
    say(f"[11c] {out['11c']}")
    if out["11c"]["b4_launches"] != 2 + 2 * cfg_r.cand_chunks or \
            not out["11c"]["finite"] or \
            not torch.allclose(scores[sel], want, **DIN_RETRIEVAL_TOL):
        raise AssertionError(f"11c: {out['11c']}")
    del scores, rb, pairs, want

    # 11e: sharded_lookup on a one-rank NCCL mesh ("model",)
    ids = bd["hist_items"][:512]
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1,), mesh_dim_names=("model",))
        c0 = D.COLLECTIVES
        got = run_phase("11e din sharded lookup", lambda: emb.sharded_lookup(
            params["item_emb"], ids, mesh))
        out["11e"] = dict(ids=ids.numel(), collectives=D.COLLECTIVES - c0,
                          equal_to_take=bool(torch.equal(
                              got, params["item_emb"][ids.long()])))
    finally:
        tdist.destroy_process_group()
    say(f"[11e] {out['11e']}")
    if out["11e"]["collectives"] != 1 or not out["11e"]["equal_to_take"]:
        raise AssertionError(f"11e: {out['11e']}")
    del bd, ids, got

    # 11d train_batch: make_train_step(din_loss), the take route
    td = to_device(torch, batch(fam.SHAPES["train_batch"]["batch"], 2), dev)
    try:
        cells.value_and_grad(lambda p, b: DIN.din_scores(
            p, b, cfg, kernel="bag").sum(), params, td)
    except ValueError as e:
        refused = str(e)
    else:
        raise AssertionError("11d: kernel='bag' under a gradient did not "
                             "raise")
    state = {"params": params, "opt": adamw.init_state(params)}
    del params
    tag = "11d din train_batch"
    rows = timed_steps(
        torch, adamw, cells.make_train_step(
            lambda p, b: DIN.din_loss(p, b, cfg), fam.OCFG),
        state, td, DIN_TRAIN_STEPS, tag, run_phase,
        flops=fam.model_flops(cfg, "train_batch"),
        items=len(td["label"]))
    out["11d"] = dict(batch=len(td["label"]), steps=rows,
                      b4_launches=b4_count(tag), bag_refused=refused[:60])
    say(f"[11d] din train_batch, {len(td['label'])} rows a step: "
        f"{summary(rows)}; B4 launches {out['11d']['b4_launches']}; "
        f"kernel='bag' under a gradient raised")
    if out["11d"]["b4_launches"]:
        raise AssertionError(f"11d: B4 launched in training: {out['11d']}")
    del state, td
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"[11] wall {out['wall_s']:.1f} s")
    return out


def grads_close(torch, tree, got, want, rtol, atol_rel) -> float:
    """The largest difference of two gradient trees (card, host), leaf by
    leaf, over ``rtol`` times the leaf and ``atol_rel`` times the tree's
    largest magnitude: at most 1 when every leaf is within the limit."""
    floor = atol_rel * max(float(w.abs().max()) for w in tree.leaves(want))
    worst = 0.0
    for g, w in zip(tree.leaves(got), tree.leaves(want)):
        excess = (g.cpu() - w).abs() / (rtol * w.abs() + floor)
        worst = max(worst, float(excess.max()))
    return worst


def reduced_card_vs_host(torch, tree, registry, make_reduced, cells,
                         dev) -> dict:
    """12a: each GNN arch at reduced_gnn and DIN at reduced_din, from the
    same host parameters and batch: the loss and every gradient on the card
    against the host."""
    out = {}
    cpu = torch.device("cpu")
    for arch in registry.GNN_ARCHS + registry.RECSYS_ARCHS:
        cfg, init_fn, loss_fn, batch_fn = make_reduced(arch, device=cpu)
        host = init_fn()
        card = tree.map_leaves(lambda x: x.to(dev, copy=True), host)
        bh = batch_fn(0)
        bd = {k: v.to(dev) for k, v in bh.items()}
        lh, gh = cells.value_and_grad(loss_fn, host, bh)
        ld, gd = cells.value_and_grad(loss_fn, card, bd)
        worst = grads_close(torch, tree, gd, gh, GNN_GRAD_RTOL,
                            GNN_GRAD_ATOL)
        out[arch] = dict(loss=float(ld), loss_err=abs(float(ld) - float(lh)),
                         grad_excess=worst)
        if not np.isclose(float(ld), float(lh), **GNN_TOL) or worst > 1:
            raise AssertionError(f"12a {arch}: the card differs from the "
                                 f"host: {out[arch]}")
    return out


def eqv2_block_card_vs_host(torch, tree, G, W, graphgen, registry,
                            dev) -> dict:
    """12b: one EquiformerV2 block at full width (C = 128, l_max 6, m_max
    2, 8 heads) on EQV2_BLOCK_GRAPHS molecules, float32, card against host:
    ``x + block(x)`` from a random x (every irrep slot set, so every SO(2)
    weight is reached) and the gradients of ``sum(out * cotangent)`` with
    respect to x and every block weight.  Weights and inputs from a host
    generator seeded with 0."""
    cfg = dataclasses.replace(registry.get_config("equiformer-v2"),
                              n_layers=1)
    b = graphgen.gnn_molecule_batch(EQV2_BLOCK_GRAPHS, 30, 2 * 64, cfg.d_in,
                                    seed=0)
    gen = torch.Generator().manual_seed(0)
    blk = G.eqv2_init(gen, cfg)["blocks"][0]
    n, E = len(b["node_feat"]), len(b["edge_index"])
    x = torch.randn((n, cfg.n_sph, cfg.d_hidden), generator=gen)
    cot = torch.randn((n, cfg.n_sph, cfg.d_hidden), generator=gen)
    res = []
    for where in (dev, torch.device("cpu")):
        ei = torch.as_tensor(b["edge_index"], device=where).long()
        pos = torch.as_tensor(b["positions"], device=where)
        src, dst = ei[:, 0], ei[:, 1]
        d_vec = pos[dst] - pos[src]
        rbf = G._rbf(torch.linalg.norm(d_vec, dim=-1) + 1e-9, cfg.n_rbf)
        D = W.wigner_stack(W.rotation_to_z(d_vec), cfg.l_max)
        mask = torch.ones(E, dtype=torch.bool, device=where)
        leaves = [a.to(where).requires_grad_(True) for a in
                  tree.leaves(blk)] + [x.to(where).requires_grad_(True)]
        lp = tree.unflatten_like(blk, leaves[:-1])
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = G._eqv2_block(leaves[-1], lp, src, dst, D, rbf, mask, cfg)
        grads = torch.autograd.grad((out * cot.to(where)).sum(), leaves)
        torch.cuda.synchronize()
        res.append((grads, (time.perf_counter() - t0) * 1e3, out.detach()))
    (gd, card_ms, od), (gh, host_ms, oh) = res
    rel = [float((g.cpu() - h).abs().max() / h.abs().max())
           for g, h in zip(gd, gh)]
    out_rel = float((od.cpu() - oh).abs().max() / oh.abs().max())
    r = dict(nodes=n, edges=E, leaves=len(rel), grad_rel_err_max=max(rel),
             grad_rel_err_min=min(rel), out_rel_err=out_rel, card_ms=card_ms,
             host_ms=host_ms)
    say(f"[12b] equiformer-v2 block at full width, float32, {E} edges, "
        f"card against host: {r}")
    if max(rel) > EQV2_GRAD_RTOL or not out_rel <= EQV2_GRAD_RTOL:
        raise AssertionError(f"12b: a gradient (or the output) differs "
                             f"between the card and the host beyond "
                             f"EQV2_GRAD_RTOL: {rel}")
    return r


def eqv2_rotation_invariance(torch, G, make_reduced, dev) -> dict:
    """12b: ``tests/test_arch_smoke.py``'s rotation-invariance check on the
    card: the reduced EquiformerV2's output with rotated positions equals
    the unrotated one within the reference's tolerance (1e-3, 1e-4)."""
    cfg, init_fn, _, batch_fn = make_reduced("equiformer-v2", device=dev)
    params, batch = init_fn(), batch_fn(0)
    q, r = np.linalg.qr(np.random.default_rng(1).standard_normal((3, 3)))
    R = q * np.sign(np.diag(r))
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    with torch.no_grad():
        out1 = G.eqv2_forward(params, batch, cfg)
        out2 = G.eqv2_forward(params, dict(
            batch, positions=batch["positions"] @ torch.as_tensor(
                R.T, dtype=torch.float32, device=dev)), cfg)
    err = float((out1 - out2).abs().max())
    say(f"[12b] rotation invariance on the card: max abs difference {err} "
        f"(outputs up to {float(out1.abs().max()):.4g})")
    if not torch.allclose(out1, out2, rtol=1e-3, atol=1e-4):
        raise AssertionError(f"12b: rotated positions moved the output by "
                             f"{err}")
    return dict(max_abs_diff=err)


def gnn_batches(graphgen, sampler, sparsify, fam, n15, e15, phi15,
                dev) -> dict:
    """12c's host batches: (nodes, edges, arrays) by run.  gat-cora's
    Cora-sized graph through gnn_full_batch; GraphSAGE's minibatch_lg from
    an Erdos-Renyi graph with Reddit's nodes (REDDIT_EDGES edges), uniform,
    and from phase 4's R-MAT graph weighted by ``sampling_weights`` (its phi
    on the card, held to phase 4a's); MeshGraphNet on the uniform batch's
    subtree with gnn_full_batch's positions, edge features and vector
    targets; EquiformerV2 on the molecule shape."""
    out, info = {}, {}
    sh = fam.SHAPES["full_graph_sm"]
    b = graphgen.gnn_full_batch(
        sh["n"], graphgen.erdos_renyi(sh["n"], sh["e"], seed=0), sh["d_feat"],
        sh["n_classes"], seed=0)
    out["gat"] = {k: b[k] for k in ("node_feat", "edge_index", "edge_mask",
                                    "labels", "label_mask")}
    sh = sh_lg = fam.SHAPES["minibatch_lg"]
    t0 = time.perf_counter()
    csr = sampler.CSR.from_edges(
        sh["n"], graphgen.erdos_renyi(sh["n"], REDDIT_EDGES, seed=0))
    info["reddit_graph_s"] = time.perf_counter() - t0
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((sh["n"], sh["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, sh["n_classes"], sh["n"]).astype(np.int32)
    t0 = time.perf_counter()
    out["sage_uniform"] = sampler.minibatch(
        csr, feats, labels, sh["batch_nodes"], sh["fanouts"], rng)
    info["uniform_sample_s"] = time.perf_counter() - t0
    del csr, feats
    t0 = time.perf_counter()
    w = sparsify.sampling_weights(n15, e15, device=dev)
    info["truss_weights_s"] = time.perf_counter() - t0
    want = np.maximum(phi15.astype(np.float64) - 1.0, 1.0)
    if not np.allclose(w, want / want.sum(), rtol=1e-6, atol=0):
        raise AssertionError("12c: sampling_weights' phi differs from phase "
                             "4a's")
    feats = rng.standard_normal((n15, sh["d_feat"]), dtype=np.float32)
    labels = rng.integers(0, sh["n_classes"], n15).astype(np.int32)
    t0 = time.perf_counter()
    out["sage_truss"] = sampler.minibatch(
        sampler.CSR.from_edges(n15, e15, edge_w=w), feats, labels,
        sh["batch_nodes"], sh["fanouts"], rng)
    info["truss_sample_s"] = time.perf_counter() - t0
    mb = out["sage_uniform"]
    n = len(mb["node_feat"])
    pos = rng.standard_normal((n, 3)).astype(np.float32)
    out["mgn"] = dict(mb, edge_feat=graphgen.edge_features(
        pos, mb["edge_index"]), targets=rng.standard_normal(
            (n, 3)).astype(np.float32), node_mask=np.ones(n, np.float32))
    for k in ("labels", "label_mask"):
        del out["mgn"][k]
    sh = fam.SHAPES["molecule"]
    b = graphgen.gnn_molecule_batch(sh["n_graphs"], sh["nodes"],
                                    2 * sh["edges"], sh["d_feat"], seed=0)
    out["eqv2"] = {k: b[k] for k in ("node_feat", "edge_index", "edge_mask",
                                     "positions", "targets", "node_mask")}
    want = {"sage_uniform": "minibatch_lg", "sage_truss": "minibatch_lg",
            "mgn": "minibatch_lg", "eqv2": "molecule"}
    for name, shape in want.items():
        # minibatch_lg's edges before the cell layer's padding to 512
        n, e = fam._flat_sizes(shape)
        if shape == "minibatch_lg":
            seeds, (f1, f2) = sh_lg["batch_nodes"], sh_lg["fanouts"]
            e = seeds * (f1 + f1 * f2)
        got = (len(out[name]["node_feat"]), len(out[name]["edge_index"]))
        if got != (n, e):
            raise AssertionError(f"12c {name}: (nodes, edges) {got}, "
                                 f"{shape} has {(n, e)}")
    info["masked_edges"] = {k: int((~out[k]["edge_mask"]).sum())
                            for k in ("sage_uniform", "sage_truss")}
    return out, info


def gnn_train_config(fam, registry, arch: str, shape: str):
    """An arch's config for a shape: the input width (and classes) of the
    shape's source; EquiformerV2's molecule edge chunks."""
    sh, base = fam.SHAPES[shape], registry.get_config(arch)
    if arch in ("gat-cora", "graphsage-reddit"):
        return dataclasses.replace(base, d_in=sh["d_feat"],
                                   n_classes=sh["n_classes"])
    if arch == "meshgraphnet":
        return dataclasses.replace(base, d_node_in=sh["d_feat"])
    return dataclasses.replace(base, d_in=sh["d_feat"],
                               edge_chunks=fam.MOLECULE_EDGE_CHUNKS)


def gnn_train_flops(fam, arch: str, cfg, n: int, e: int) -> float:
    """gnn_family's flops of one training step on n nodes and e edges."""
    if arch == "gat-cora":
        return fam.gat_flops(cfg, n, e, cfg.d_in, cfg.n_classes)
    if arch == "graphsage-reddit":
        return fam.sage_flops(cfg, n, e, cfg.d_in)
    if arch == "meshgraphnet":
        return fam.mgn_flops(cfg, n, e)
    return fam.eqv2_flops(cfg, n, e)


def gnn_phases(torch, run_phase, phase_launches, n15, e15, phi15,
               dev) -> dict:
    """Phase 12: the GNN archs (and DIN's reduced config in 12a)."""
    from repro_torch import tree
    from repro_torch.configs import cells, registry
    from repro_torch.configs import gnn_family as fam
    from repro_torch.configs.reduced import make_reduced
    from repro_torch.core import sparsify
    from repro_torch.data import graphgen
    from repro_torch.models.gnn import models as G
    from repro_torch.models.gnn import sampler
    from repro_torch.models.gnn import wigner as W
    from repro_torch.optim import adamw

    t_phase = time.perf_counter()
    out = {"12a": run_phase("12a reduced GNN archs and DIN card against host",
                            lambda: reduced_card_vs_host(
                                torch, tree, registry, make_reduced, cells,
                                dev))}
    say(f"[12a] card against host: {json.dumps(out['12a'])}")
    out["12b"] = run_phase("12b equiformer-v2 block card against host",
                           lambda: eqv2_block_card_vs_host(
                               torch, tree, G, W, graphgen, registry, dev))
    out["12b"]["rotation"] = eqv2_rotation_invariance(torch, G, make_reduced,
                                                      dev)
    t0 = time.perf_counter()
    batches, info = gnn_batches(graphgen, sampler, sparsify, fam, n15, e15,
                                phi15, dev)
    info["host_batches_s"] = time.perf_counter() - t0
    say(f"[12c] host batches: {info}")
    out["12c"] = {"host": info}
    runs = (
        ("gat", "gat-cora", "full_graph_sm", G.gat_init, G.gat_loss),
        ("sage_uniform", "graphsage-reddit", "minibatch_lg", G.sage_init,
         G.sage_loss),
        ("sage_truss", "graphsage-reddit", "minibatch_lg", G.sage_init,
         G.sage_loss),
        ("mgn", "meshgraphnet", "minibatch_lg", G.mgn_init, G.mgn_loss),
        ("eqv2", "equiformer-v2", "molecule", G.eqv2_init, G.eqv2_loss))
    for name, arch, shape, init, loss in runs:
        cfg = gnn_train_config(fam, registry, arch, shape)
        b = batches.pop(name)
        n, e = len(b["node_feat"]), len(b["edge_index"])
        flops = gnn_train_flops(fam, arch, cfg, n, e)
        torch.cuda.empty_cache()
        params = init(torch.Generator(device=dev).manual_seed(0), cfg)
        state = {"params": params, "opt": adamw.init_state(params)}
        n_params = sum(a.numel() for a in tree.leaves(params))
        del params
        tag = f"12c train {arch} {shape}" + (
            " truss-weighted" if name == "sage_truss" else "")
        rows = timed_steps(
            torch, adamw, cells.make_train_step(
                lambda p, bb: loss(p, bb, cfg), fam.OCFG),
            state, to_device(torch, b, dev), GNN_TRAIN_STEPS, tag, run_phase,
            flops=flops, items=n)
        out["12c"][name] = dict(arch=arch, shape=shape, nodes=n, edges=e,
                                params=n_params, flops=flops, steps=rows)
        say(f"[12c] {name}: {arch} x {shape}, {n:,} nodes, {e:,} edges, "
            f"{n_params:,} parameters, {flops:.4g} flops a step: "
            f"{summary(rows)}")
        del state, b
        if any(phase_launches[tag].values()):
            raise AssertionError(f"12c {name}: a kernel launched: "
                                 f"{phase_launches[tag]}")
    torch.cuda.empty_cache()
    out["wall_s"] = time.perf_counter() - t_phase
    say(f"[12] wall {out['wall_s']:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 13: the cell and dry-run layer
# ---------------------------------------------------------------------------

DRY11_CHILD = r"""
import json, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from torch.distributed.device_mesh import init_device_mesh
from repro_torch.configs import registry
from repro_torch.launch import dryrun

recs = []
with dryrun.fake_group(1):
    mesh = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data", "model"))
    for arch, shape in json.loads(sys.argv[1]):
        recs.append(dryrun.run_cell(registry.get_cell(arch, shape), mesh,
                                    "1x1"))
print("DRY11_RESULT " + json.dumps(recs), flush=True)
"""


def start_dryruns(tmp: str) -> dict:
    """13a's and 13b's dry runs as child processes that never touch the card
    (``CUDA_VISIBLE_DEVICES`` empty), started when the smoke starts, at
    nice 19 (their pool workers inherit it): every cell on pod16x16
    (``python -m repro_torch.launch.dryrun --all``), and CELL_RUNS on a
    (1, 1) mesh.  Their output goes to files under ``tmp``."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    out = {"tmp": tmp, "t0": time.perf_counter()}
    for name, cmd in (
            ("pod16x16", [sys.executable, "-m", "repro_torch.launch.dryrun",
                          "--all", "--jobs", str(DRYRUN_JOBS), "--out",
                          os.path.join(tmp, "pod16x16.json")]),
            ("1x1", [sys.executable, "-c", DRY11_CHILD,
                     json.dumps(CELL_RUNS)])):
        log = open(os.path.join(tmp, f"{name}.log"), "w")
        out[name] = (subprocess.Popen(cmd, env=env, cwd=str(ROOT), stdout=log,
                                      stderr=subprocess.STDOUT,
                                      preexec_fn=lambda: os.nice(19)), log)
    return out


def stop_dryruns(dry: dict) -> None:
    """Kill whatever dry-run child is still running and close its log."""
    for name in ("pod16x16", "1x1"):
        p, log = dry[name]
        if p.poll() is None:
            p.kill()
            p.wait()
        log.close()


def wait_dryrun(dry: dict, name: str, timeout: float) -> str:
    p, log = dry[name]
    try:
        p.wait(timeout=timeout)
    except subprocess.TimeoutExpired:
        p.kill()
        p.wait()
        with open(os.path.join(dry["tmp"], f"{name}.log")) as f:
            done = [ln for ln in f.read().splitlines()
                    if ln.startswith("[dryrun]")]
        raise AssertionError(
            f"13: the {name} dry run did not end within {timeout:.0f} s of "
            f"phase 13, {time.perf_counter() - dry['t0']:.0f} s after it "
            f"started (killed); its records so far:\n" + "\n".join(done))
    log.flush()
    with open(os.path.join(dry["tmp"], f"{name}.log")) as f:
        text = f.read()
    if p.returncode != 0:
        raise AssertionError(f"13: the {name} dry run exited "
                             f"{p.returncode}: {text[-3000:]}")
    return text


def dryrun_phase(run_phase, dry: dict) -> dict:
    """13a: wait for the pod16x16 dry run; every record must be ok.  Prints
    report.render's table, the bottleneck counts and the cells whose
    per-device arg_bytes + temp_bytes fit one card's 80 GiB."""
    from repro_torch.launch import report

    run_phase("13a dry run pod16x16", lambda: wait_dryrun(
        dry, "pod16x16", DRYRUN_WAIT_S))
    with open(os.path.join(dry["tmp"], "pod16x16.json")) as f:
        recs = json.load(f)
    wall = time.perf_counter() - dry["t0"]
    for line in report.render(recs, "Mesh pod16x16 (chip_smoke 13a)"
                              ).splitlines():
        say(f"[13a] {line}")
    bad = [f"{r['arch']}×{r['shape']}: {r.get('error')}" for r in recs
           if not r.get("ok")]
    fits = [f"{r['arch']}×{r['shape']}" for r in recs if r.get("ok") and
            r["arg_bytes"] + r["temp_bytes"] <= 80 * 2 ** 30]
    out = dict(cells=len(recs), ok=len(recs) - len(bad), wall_s=wall,
               trace_s={f"{r['arch']}×{r['shape']}": r.get("trace_s")
                        for r in recs},
               bottlenecks={b: sum(r.get("bottleneck") == b for r in recs)
                            for b in ("compute", "memory", "collective")},
               fit_80gib=fits, records=[{k: r.get(k) for k in (
                   "arch", "shape", "kind", "ok", "trace_s", "arg_bytes",
                   "out_bytes", "temp_bytes", "flops_per_device",
                   "bytes_per_device", "collective_bytes_per_device",
                   "t_compute", "t_memory", "t_collective", "bottleneck",
                   "model_flops_ratio", "roofline_fraction")}
                   for r in recs])
    say(f"[13a] {out['ok']}/{out['cells']} ok, child wall {wall:.1f} s "
        f"({DRYRUN_JOBS} workers); bottlenecks {out['bottlenecks']}; "
        f"per-device arg + temp within 80 GiB: {fits}")
    say(f"[13a] trace s by cell: {out['trace_s']}")
    if bad or len(recs) != 40:
        raise AssertionError(f"13a: {len(recs)} records, failed: {bad}")
    return out


def card_args(torch, tree, args, ranges: dict, dev, gen):
    """Real inputs on the card in the abstract args' shapes and dtypes, from
    ``gen``: the parameters (arg 0) normal times 0.02, other floats normal,
    float masks and labels 0/1, bools at random, integer ids below
    ``ranges[name]`` (a GNN's edge_index below its node count)."""
    paths, leaves = tree.flatten_with_paths(args)
    ranges = dict(ranges)
    for p, t in zip(paths, leaves):
        if p.endswith("/node_feat"):
            ranges["edge_index"] = t.shape[0]
    out = []
    for p, t in zip(paths, leaves):
        key, shape = p.split("/")[-1], tuple(t.shape)
        if t.dtype == torch.bool:
            x = torch.rand(shape, generator=gen, device=dev) < 0.8
        elif t.dtype.is_floating_point:
            if key.endswith("mask") or key == "label":
                x = (torch.rand(shape, generator=gen, device=dev)
                     < 0.8).to(t.dtype)
            else:
                x = (torch.randn(shape, generator=gen, device=dev)
                     * (0.02 if p.startswith("0/") else 1.0)).to(t.dtype)
        else:
            x = torch.randint(0, ranges.get(key, 1), shape, generator=gen,
                              device=dev, dtype=t.dtype)
        out.append(x)
    return tree.unflatten_like(args, out)


def cell_runs(torch, run_phase, phase_launches, dry: dict, dev) -> dict:
    """13b: CELL_RUNS built on a one-rank NCCL (1, 1) mesh and run once on
    the card, each against the dry run's (1, 1) record of the same cell."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.configs import gnn_family as gnn_fam
    from repro_torch.configs import registry
    from repro_torch.models.common import use_mesh
    from repro_torch.optim import adamw

    text = wait_dryrun(dry, "1x1", 60)
    line = [ln for ln in text.splitlines() if ln.startswith("DRY11_RESULT ")]
    recs = {f"{r['arch']}×{r['shape']}": r
            for r in json.loads(line[-1].split(" ", 1)[1])}
    out = {}
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                                "model"))
        for arch, shape in CELL_RUNS:
            key = f"{arch}×{shape}"
            rec = recs[key]
            if not rec.get("ok"):
                raise AssertionError(f"13b: the (1, 1) dry run of {key} "
                                     f"failed: {rec.get('error')}")
            cell = registry.get_cell(arch, shape)
            fn, args, _ = cell.build(mesh)[:3]
            if arch == "din":
                cfg = registry.get_config("din")
                ranges = {k: cfg.n_items for k in ("hist_items", "cand_item",
                                                   "cand_items")}
                ranges.update({k: cfg.n_cats for k in (
                    "hist_cats", "cand_cat", "cand_cats")})
            else:
                ranges = {"labels": gnn_fam.SHAPES[shape].get("n_classes",
                                                              2)}
            gen = torch.Generator(device=dev).manual_seed(0)
            real = card_args(torch, tree, args, ranges, dev, gen)
            if cell.kind == "train":
                real = (real[0], adamw.init_state(real[0]), real[2])
            arg_bytes = sum(t.untyped_storage().nbytes() for t in {
                t.untyped_storage().data_ptr(): t
                for t in tree.leaves(real)}.values())
            torch.cuda.synchronize()
            mem0 = torch.cuda.memory_allocated()

            def step():
                with use_mesh(mesh):
                    res = fn(*real)
                torch.cuda.synchronize()
                return res

            t0 = time.perf_counter()
            res = run_phase(f"13b cell {key}", step)
            wall = time.perf_counter() - t0
            temp = torch.cuda.max_memory_allocated() - mem0
            ratio = max(temp, TEMP_FLOOR) / max(rec["temp_bytes"], TEMP_FLOOR)
            peak = BF16_FLOPS_PER_S if any(
                t.dtype == torch.bfloat16 for t in tree.leaves(real[0])) \
                else FP32_FLOPS_PER_S
            finite = all(bool(torch.isfinite(t).all()) for t in
                         tree.leaves(res) if isinstance(t, torch.Tensor)
                         and t.is_floating_point())
            out[key] = dict(
                kind=cell.kind, arg_bytes=arg_bytes,
                dry_arg_bytes=rec["arg_bytes"], temp_bytes=temp,
                dry_temp_bytes=rec["temp_bytes"], temp_ratio=ratio,
                wall_s=wall, model_flops=cell.model_flops,
                mfu=cell.model_flops / wall / peak, peak_flops=peak,
                b4_launches=phase_launches[f"13b cell {key}"]["B4"],
                finite=finite)
            say(f"[13b] {key}: {out[key]}")
            want_b4 = CELL_B4.get(shape, 0) if arch == "din" else 0
            if arg_bytes != rec["arg_bytes"] or not finite or \
                    not 1 / TEMP_FACTOR <= ratio <= TEMP_FACTOR or \
                    out[key]["b4_launches"] != want_b4 or any(
                        v for k, v in phase_launches[f"13b cell {key}"].items()
                        if k != "B4"):
                raise AssertionError(f"13b {key}: {out[key]} (B4 expected "
                                     f"{want_b4})")
            del real, res
            torch.cuda.empty_cache()
    finally:
        tdist.destroy_process_group()
    return out


RING_CHILD = r"""
import json, sys, time
sys.modules["jax"] = None
sys.modules["repro"] = None
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh
sys.path.insert(0, sys.argv[4])
import chip_smoke as S

rendezvous, rank, world = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
torch.cuda.set_device(0)
torch.backends.cuda.matmul.allow_tf32 = False
dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                        rank=rank, world_size=world)
mesh = init_device_mesh("cuda", (1, world), mesh_dim_names=("data", "model"))
out = S.ring_checks(torch, mesh, torch.device("cuda"), f"rank {rank}",
                    full=False)
print("RING_RESULT " + json.dumps(out), flush=True)
dist.barrier()
dist.destroy_process_group()
"""


def ring_graph(P: int, seed: int = 0) -> tuple:
    """A seeded synthetic graph of P * RING_W nodes whose every (owner,
    destination block) bucket holds RING_EB directed edges (full buckets),
    with positions: (edge_index, positions)."""
    rng = np.random.default_rng(seed)
    parts = []
    for o in range(P):
        for b in range(P):
            parts.append(np.stack([o * RING_W + rng.integers(0, RING_W,
                                                             RING_EB),
                                   b * RING_W + rng.integers(0, RING_W,
                                                             RING_EB)], 1))
    pos = rng.standard_normal((P * RING_W, 3)).astype(np.float32)
    return np.concatenate(parts).astype(np.int32), pos


def ring_checks(torch, mesh, dev, tag: str, full: bool = True) -> dict:
    """13c on this rank of ``mesh`` (("data", "model"), P ranks): both ring
    losses at the production per-device block against the plain losses on
    the card, float32 payload; the forward-and-backward wall, the peak and
    the collective calls; one AdamW step.  With ``full`` also the forward
    alone (after an untimed one), the collectives counted by
    ``hlo_analysis``, and EquiformerV2's bf16 payload timed with its loss
    beside the float32 one."""
    import dataclasses as dc

    from repro_torch import tree
    from repro_torch.configs import gnn_family as fam
    from repro_torch.configs import registry
    from repro_torch.configs.cells import value_and_grad
    from repro_torch.core import distributed as D
    from repro_torch.launch import hlo_analysis
    from repro_torch.models.gnn import distributed as RD
    from repro_torch.models.gnn import models as G
    from repro_torch.optim import adamw

    group, P, me = RD.ring_group(mesh)
    ei, pos = ring_graph(P)
    n = P * RING_W
    bk = RD.bucket_edges_by_owner(n, ei, pos, P, pad_factor=1.0)
    if bk["src_loc"].shape[2] != RING_EB or bk["overflow"] or \
            not bk["edge_mask"].all():
        raise AssertionError(f"13c: buckets {bk['src_loc'].shape}, overflow "
                             f"{bk['overflow']}")
    sh = fam.SHAPES["ogb_products"]
    rng = np.random.default_rng(1)
    nf = rng.standard_normal((n, sh["d_feat"])).astype(np.float32)
    labels = rng.integers(0, sh["n_classes"], n).astype(np.int32)
    lmask = (rng.random(n) < 0.5).astype(np.float32)
    tgt = rng.standard_normal(n).astype(np.float32)
    T = lambda a: torch.as_tensor(a, device=dev)
    lo, hi = me * RING_W, (me + 1) * RING_W
    slab = {k: T(bk[k][me:me + 1]) for k in ("src_loc", "dst_loc",
                                            "edge_mask", "dst_pos")}
    runs = {
        "sage": (dc.replace(registry.get_config("graphsage-reddit"),
                            d_in=sh["d_feat"], n_classes=sh["n_classes"]),
                 G.sage_init, G.sage_loss, RD.sage_ring_loss,
                 {"node_feat": T(nf), "edge_index": T(ei), "labels": T(labels),
                  "label_mask": T(lmask)},
                 {"node_feat": T(nf[lo:hi]), "labels": T(labels[lo:hi]),
                  "label_mask": T(lmask[lo:hi]),
                  **{k: slab[k] for k in ("src_loc", "dst_loc",
                                          "edge_mask")}}),
        "eqv2": (dc.replace(registry.get_config("equiformer-v2"),
                            d_in=sh["d_feat"], ring_dtype="f32"),
                 G.eqv2_init, G.eqv2_loss, RD.eqv2_ring_loss,
                 {"node_feat": T(nf), "edge_index": T(ei), "positions": T(pos),
                  "targets": T(tgt), "node_mask": T(np.ones(n, np.float32))},
                 {"node_feat": T(nf[lo:hi]), "positions": T(pos[lo:hi]),
                  "targets": T(tgt[lo:hi]),
                  "node_mask": T(np.ones(RING_W, np.float32)), **slab}),
    }
    out = {"P": P, "W": RING_W, "Eb": RING_EB, "edges": int(len(ei))}
    for name, (cfg, init, plain, ring, whole, local) in runs.items():
        params = init(torch.Generator(device=dev).manual_seed(0), cfg)
        lp, gp = value_and_grad(lambda p, b: plain(p, b, cfg), params, whole)
        ring_loss = lambda p, b, cfg=cfg: ring(p, b, cfg, mesh)
        fwd = None
        if full:
            for _ in range(2):          # the first call sets up the ring
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                with torch.no_grad():
                    ring_loss(params, local)
                torch.cuda.synchronize()
                fwd = time.perf_counter() - t0
        torch.cuda.reset_peak_memory_stats()
        mem0 = torch.cuda.memory_allocated()
        c0 = D.COLLECTIVES
        t0 = time.perf_counter()
        lr, gr = value_and_grad(ring_loss, params, local)
        torch.cuda.synchronize()
        fwdbwd = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() - mem0
        calls = D.COLLECTIVES - c0
        counted = hlo_analysis.analyze(lambda: value_and_grad(
            ring_loss, params, local)) if full else {}
        rel = [float((a - b).abs().max() / (b.abs().max() + 1e-6))
               for a, b in zip(tree.leaves(gr), tree.leaves(gp))]
        C = getattr(cfg, "d_hidden", 0)
        x_loc = RING_W * (cfg.n_sph * C if name == "eqv2" else max(
            sh["d_feat"], C)) * 4
        block = x_loc + RING_W * (cfg.n_heads if name == "eqv2" else 1) * 4
        r = dict(loss=float(lr), plain_loss=float(lp),
                 loss_rel_err=abs(float(lr) - float(lp)) / abs(float(lp)),
                 grad_rel_err_max=max(rel), fwd_s=fwd, fwdbwd_s=fwdbwd,
                 peak_bytes=peak, x_loc_plus_block_bytes=x_loc + block,
                 collective_calls=calls,
                 collective_counts=counted.get("collective_counts"),
                 collective_bytes=counted.get("collective_bytes"),
                 flops=counted.get("flops"))
        if full and name == "eqv2":
            cfg16 = dc.replace(cfg, ring_dtype="bf16")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            l16, _ = value_and_grad(lambda p, b: ring(p, b, cfg16, mesh),
                                    params, local)
            torch.cuda.synchronize()
            r.update(bf16_fwdbwd_s=time.perf_counter() - t0,
                     bf16_loss=float(l16),
                     bf16_loss_rel_diff=abs(float(l16) - float(lr))
                     / abs(float(lr)))
        state = adamw.init_state(params)
        params, state, m = adamw.update(fam.OCFG, params, state, gr)
        r["adamw_finite"] = bool(all(torch.isfinite(t).all()
                                     for t in tree.leaves(params))
                                 and torch.isfinite(m["grad_norm"]))
        say(f"[13c] {tag} {name}: {r}")
        if not (r["loss_rel_err"] <= RING_LOSS_RTOL
                and r["grad_rel_err_max"] <= RING_GRAD_REL
                and r["adamw_finite"]):
            raise AssertionError(f"13c {tag} {name}: the ring differs from "
                                 f"the plain loss: {r}")
        out[name] = r
        del params, state, gp, gr
        torch.cuda.empty_cache()
    return out


def ring_phases(torch, run_phase, phase_launches, dev) -> dict:
    """13c: both ring losses on a one-rank NCCL (1, 1) mesh in this
    process, then on two gloo ranks sharing the card (child processes
    importing only ``repro_torch`` and this script)."""
    import torch.distributed as tdist
    from torch.distributed.device_mesh import init_device_mesh

    out = {}
    tdist.init_process_group("nccl", store=tdist.HashStore(), rank=0,
                             world_size=1)
    try:
        mesh = init_device_mesh("cuda", (1, 1), mesh_dim_names=("data",
                                                                "model"))
        tag = "13c ring one NCCL rank"
        out["nccl_1"] = run_phase(tag, lambda: ring_checks(
            torch, mesh, dev, "1 rank"))
    finally:
        tdist.destroy_process_group()
    if any(phase_launches[tag].values()):
        raise AssertionError(f"13c: a kernel launched: {phase_launches[tag]}")
    with tempfile.TemporaryDirectory(prefix="chip_smoke_ring_") as d:
        env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
        procs = [subprocess.Popen(
            [sys.executable, "-c", RING_CHILD, os.path.join(d, "rendezvous"),
             str(rank), "2", str(ROOT)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.PIPE, text=True) for rank in (0, 1)]

        def wait():
            deadline = time.perf_counter() + 300
            outs = []
            try:
                for p in procs:
                    outs.append(p.communicate(
                        timeout=max(1.0, deadline - time.perf_counter())))
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                        p.wait()
            return outs

        try:
            outs = run_phase("13c ring two gloo ranks", wait)
        except subprocess.TimeoutExpired:
            raise AssertionError("13c: the two ring ranks did not finish "
                                 "within 300 s (killed)")
    for rank, (p, (so, se)) in enumerate(zip(procs, outs)):
        line = [ln for ln in so.splitlines() if ln.startswith("RING_RESULT ")]
        if p.returncode != 0 or not line:
            raise AssertionError(f"13c: ring rank {rank} exited "
                                 f"{p.returncode}: {so[-1500:]} {se[-3000:]}")
        out[f"gloo_2_rank{rank}"] = json.loads(line[-1].split(" ", 1)[1])
        say(f"[13c] two gloo ranks, rank {rank}: "
            f"{out[f'gloo_2_rank{rank}']}")
    return out


# -- phase 14: the static-analysis pass and the kernels' shared memory ----

def trusscheck_phase(run_phase) -> dict:
    """Phase 14a: ``python -m repro_torch.analysis src/repro_torch --json -``
    as a child process; it must exit 0.  Returns the files checked, the
    errors and the allowlisted findings per rule."""
    def run():
        return subprocess.run(
            [sys.executable, "-m", "repro_torch.analysis", "src/repro_torch",
             "--json", "-"], cwd=ROOT, capture_output=True, text=True,
            timeout=300, env=dict(os.environ, PYTHONPATH=str(ROOT / "src")))

    proc = run_phase("14a trusscheck", run)
    lines = proc.stdout.splitlines()
    if proc.returncode != 0 or "{" not in lines:
        raise AssertionError(f"trusscheck exited {proc.returncode}:\n"
                             f"{proc.stdout[-4000:]}{proc.stderr[-2000:]}")
    rep = json.loads("\n".join(lines[lines.index("{"):lines.index("}") + 1]))
    allow: dict = {}
    for f in rep["findings"]:
        if f["allowlisted"]:
            allow[f["rule_id"]] = allow.get(f["rule_id"], 0) + 1
    out = dict(exit=proc.returncode, files_checked=rep["files_checked"],
               errors=rep["errors"], allowlisted=allow)
    say(f"[14a] trusscheck over src/repro_torch: exit {proc.returncode}, "
        f"{rep['files_checked']} files, {rep['errors']} errors, "
        f"allowlisted by rule {allow or 'none'}")
    return out


def smem_optin_limit(torch) -> tuple[int, str]:
    """The card's shared memory per block with opt-in, in bytes, and where
    it was read."""
    props = torch.cuda.get_device_properties(0)
    limit = getattr(props, "shared_memory_per_block_optin", None)
    if limit:
        return int(limit), "torch shared_memory_per_block_optin"
    import ctypes
    for cand in ("libcudart.so", "libcudart.so.12",
                 "/usr/local/cuda/lib64/libcudart.so"):
        try:
            rt = ctypes.CDLL(cand)
        except OSError:
            continue
        value = ctypes.c_int(0)
        # cudaDevAttrMaxSharedMemoryPerBlockOptin
        rc = rt.cudaDeviceGetAttribute(ctypes.byref(value), 97,
                                       torch.cuda.current_device())
        if rc == 0 and value.value:
            return value.value, f"cudaDeviceGetAttribute ({cand})"
    raise AssertionError("cannot read the card's opt-in shared memory limit")


def smem_entries(torch, build, fk, tk, ak, bk, dk, b1_E: int) -> list:
    """Every kernel entry of the five ptxas reports with the shared memory
    one block of it takes at the largest input its paths gave it: ptxas's
    static bytes plus the binding's dynamic estimate (its ``smem_bytes``
    less its ``STATIC_SMEM_BYTES``), beside the binding's Python estimate
    and the source's C export of the same formula.  B1 is evaluated at the
    truss path's largest-estimate E (``b1_E``) and at the largest E whose
    lane state still goes to shared memory; B2 is the same at every n; B3's
    instantiations each at their widest head dimension (bf16 D = 128 and
    D = 256 the LM paths'); B4 the same at every shape (DIN's D); B5's
    kernel instantiations each at D = 256 and their group bucket (the most
    either asks), its combine none."""
    b1_cap = fk.MAX_SMEM_BYTES // 8 * 32
    rows = []
    for src in ("frontier_peel", "triangle_count", "flash_attention",
                "embedding_bag", "decode_attention"):
        for entry, r in ptxas_kernels(build.report(src)).items():
            # (what, estimate, C export, declared static[, dynamic]); the
            # dynamic part defaults to the estimate less the static
            cases = []
            name = entry
            if src == "frontier_peel" and B1_TRACE_NAME in entry:
                name = B1_TRACE_NAME
                for what, E in ((f"E={b1_E} (truss path)", b1_E),
                                (f"E={b1_cap} (largest in shared memory)",
                                 b1_cap)):
                    cases.append((what, fk.smem_bytes(E),
                                  fk.c_smem_bytes(E), fk.STATIC_SMEM_BYTES))
            elif src == "triangle_count" and B2_TRACE_NAME in entry:
                name = B2_TRACE_NAME
                cases.append(("every n (2,048 on the path)",
                              tk.smem_bytes(), tk.c_smem_bytes(),
                              tk.STATIC_SMEM_BYTES))
            elif src == "flash_attention":
                m = re.search(r"(tc|f32)_kernelILi(\d+)E", entry)
                if m is not None:
                    bf16 = m[1] == "tc"
                    d = int(m[2]) if bf16 else 16 * int(m[2])
                    dtype = torch.bfloat16 if bf16 else torch.float32
                    name = f"{m[1]}_kernel<{m[2]}>"
                    cases.append((f"D={d} {'bf16' if bf16 else 'float32'}",
                                  ak.smem_bytes(d, dtype),
                                  ak.c_smem_bytes(d, dtype),
                                  ak.STATIC_SMEM_BYTES))
            elif src == "embedding_bag":
                m = re.search(B4_ENTRY_RE, entry)
                if m is not None:
                    dtype = "float32" if m[2] == "f" else "bf16"
                    name = f"{m[1]}<{dtype}, {m[3]}>"
                uses = {fn: use for use, fn in B4_ENTRY_FN.items()}
                if m is not None and m[1] in uses:
                    # the binding's estimate is the larger entry's; each
                    # entry's own static bytes are held to ptxas's, and
                    # neither asks for dynamic shared memory
                    cases.append(("every shape (DIN's D=18 included)",
                                  bk.smem_bytes(), bk.c_smem_bytes(),
                                  bk.ENTRY_STATIC_SMEM_BYTES[uses[m[1]]],
                                  0))
                elif m is not None:     # the probe asks for none
                    cases.append(("every shape (no estimate: none asked)",
                                  0, 0, 0, 0))
            elif src == "decode_attention":
                m = re.search(B5_KERNEL_RE, entry)
                if m is not None:
                    dtype = torch.float32 if m[2] == "f" else torch.bfloat16
                    dn = "float32" if m[2] == "f" else "bf16"
                    if m[1] == "kernel":
                        g = int(m[3])
                        name = f"decode_attention_kernel<{dn}, {g}>"
                        cases.append((f"D=256 group {g} {dn}",
                                      dk.smem_bytes(256, g, dtype),
                                      dk.c_smem_bytes(256, g, dtype),
                                      dk.STATIC_SMEM_BYTES))
                    else:           # the combine asks for none
                        name = f"decode_attention_combine<{dn}>"
                        cases.append(("every shape (none asked)", 0, 0, 0,
                                      0))
            if not cases:
                raise AssertionError(f"{src}: kernel entry {entry} has no "
                                     f"shared-memory estimate")
            for what, est, c_est, static, *dynamic in cases:
                rows.append(dict(
                    kernel=src, entry=name, symbol=entry, at=what,
                    static=r["static_smem"],
                    dynamic=dynamic[0] if dynamic else est - static,
                    estimate=est, c_export=c_est,
                    declared_static=static))
    return rows


def smem_phase(torch, run_phase, build, fk, tk, ak, bk, dk, b1_E: int,
               smi: str) -> dict:
    """Phase 14b: every kernel entry's ptxas static shared memory plus its
    binding's dynamic estimate within the card's per-block opt-in limit,
    each Python estimate equal to its C export and its static part to
    ptxas's, and ``build.SMEM_BUDGET_BYTES`` equal to the card's limit."""
    limit, source = smem_optin_limit(torch)
    rows = run_phase("14b shared memory", lambda: smem_entries(
        torch, build, fk, tk, ak, bk, dk, b1_E))
    say(f"[14b] the card's opt-in limit {limit} bytes ({source}); "
        f"SMEM_BUDGET_BYTES {build.SMEM_BUDGET_BYTES}; {smi}")
    bad = []
    if build.SMEM_BUDGET_BYTES != limit:
        bad.append(f"SMEM_BUDGET_BYTES {build.SMEM_BUDGET_BYTES} != the "
                   f"card's {limit}")
    for r in rows:
        r["total"] = r["static"] + r["dynamic"]
        r["headroom"] = limit - r["total"]
        say(f"[14b] {r['kernel']} {r['entry']} at {r['at']}: static "
            f"{r['static']} (ptxas) + dynamic {r['dynamic']} = {r['total']} "
            f"of {limit} bytes, headroom {r['headroom']}; estimate "
            f"{r['estimate']}, C export {r['c_export']}; {smi}")
        if r["total"] > limit:
            bad.append(f"{r['kernel']} {r['entry']} at {r['at']} needs "
                       f"{r['total']} bytes")
        if r["estimate"] != r["c_export"]:
            bad.append(f"{r['kernel']} at {r['at']}: estimate "
                       f"{r['estimate']} != C export {r['c_export']}")
        if r["static"] != r["declared_static"]:
            bad.append(f"{r['kernel']} {r['entry']}: ptxas static "
                       f"{r['static']} != the binding's "
                       f"{r['declared_static']}")
    if bad:
        raise AssertionError("phase 14b: " + "; ".join(bad))
    return dict(limit=limit, limit_source=source, entries=rows)


# 5c's host oracles on er2048, in a child process started with the dry runs
# (nice 19, beside phases 2-5): the triangle list's rows and the supports
DENSE_ORACLE_CHILD = r"""
import json, sys, time
sys.modules["jax"] = None
sys.modules["repro"] = None
import numpy as np
from repro_torch.core.graph import build_graph
from repro_torch.core.support import edge_support_np, list_triangles_np
from repro_torch.data.graphgen import erdos_renyi
out = sys.argv[1]
g = build_graph(2048, erdos_renyi(2048, 314_000, seed=5))
t0 = time.perf_counter()
n_tris = len(list_triangles_np(g))
np.save(out + ".sup.npy", edge_support_np(g))
np.save(out + ".edges.npy", g.edges)
with open(out + ".json", "w") as f:
    json.dump({"triangles": n_tris, "host_s": time.perf_counter() - t0}, f)
"""
DENSE_ORACLE_WAIT_S = 600


def start_dense_oracles(tmp: str) -> tuple:
    """``DENSE_ORACLE_CHILD`` at nice 19, off the card; (process, path)."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), OMP_NUM_THREADS="1",
               CUDA_VISIBLE_DEVICES="")
    path = os.path.join(tmp, "er2048")
    proc = subprocess.Popen([sys.executable, "-c", DENSE_ORACLE_CHILD, path],
                            env=env, cwd=str(ROOT), stdout=subprocess.DEVNULL,
                            stderr=subprocess.PIPE,
                            preexec_fn=lambda: os.nice(19))
    atexit.register(lambda: proc.poll() is None and proc.kill())
    return proc, path


def dense_core_check(torch, tk, tref, build_graph, A, kw, oracles) -> dict:
    """Phase 5c, after the truss path's counts are read: B2's S of the
    dense core that 5c's top-down gave it (the whole er2048 graph, its ids
    unchanged by the relabelling, which is checked), its total
    (``ref.triangle_total``) against the rows of the host triangle list
    (``list_triangles_np``) and its per-edge supports (``ref.edge_support``
    at the core's canonical edges) against ``edge_support_np``: both exact.
    The two host oracles ran in ``oracles``' child process."""
    S = tk.triangle_count(A, **kw)
    n = A.shape[0]
    g = build_graph(n, torch.nonzero(torch.triu(A, 1)).cpu().numpy())
    total = float(tref.triangle_total(S))
    got = tref.edge_support(S, torch.as_tensor(g.edges, device=A.device))
    got = got.cpu().numpy()
    proc, path = oracles
    t0 = time.perf_counter()
    try:
        _, err = proc.communicate(timeout=DENSE_ORACLE_WAIT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        proc.wait()
        raise AssertionError(f"5c: the host oracles did not end within "
                             f"{DENSE_ORACLE_WAIT_S} s of phase 5c")
    waited = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"5c: the host oracles exited "
                             f"{proc.returncode}: {err.decode()[-3000:]}")
    with open(path + ".json") as f:
        info = json.load(f)
    if not np.array_equal(np.load(path + ".edges.npy"), g.edges):
        raise AssertionError("5c: the dense core is not er2048 in its own "
                             "vertex ids")
    sup, n_tris = np.load(path + ".sup.npy"), info["triangles"]
    if total != n_tris:
        raise AssertionError(f"5c: triangle_total of B2's S is {total}, the "
                             f"host triangle list has {n_tris} rows")
    if got.shape != sup.shape or not np.array_equal(got, sup):
        raise AssertionError(f"5c: edge_support of B2's S differs from "
                             f"edge_support_np on "
                             f"{int((got != sup).sum())} of {g.m} edges")
    out = dict(n=n, m=g.m, triangles=n_tris, triangle_total=total,
               edges_equal=g.m, host_oracles_s=round(info["host_s"], 3),
               waited_s=round(waited, 3))
    say(f"[5c] dense core n={n} m={g.m}: triangle_total(S) {total} equals "
        f"list_triangles_np's {n_tris} rows, edge_support(S, edges) equals "
        f"edge_support_np on all {g.m} edges (host oracles "
        f"{info['host_s']:.3f} s in a child at nice 19 beside phases 2-5c; "
        f"waited {waited:.3f} s for them)")
    return out


def algorithm1_phase(serial, truss_decompose, kmax_truss, canonical_edges,
                     rmat, run_phase, phase_walls, fig2, n17, e17, phi17,
                     kmax_truss17, smi, dev) -> dict:
    """Phase 6's additions: the paper's Algorithm 1 (``alg1_truss``) on the
    Figure-2 graph and on rmat13 (5f's graph), its phi equal to the rmat13
    digest and to ``alg2_truss``'s; one line with both host walls and the
    in-memory ``truss_decompose`` wall on the card for that graph (the
    paper's Table 3 in miniature, gating nothing); ``truss_from_phi`` on
    phase 3's graph and phi at k_max equal, as a set, to 8c's k_max-truss
    (and its size to the JAX package's), and on rmat13 to ``kmax_truss``'s
    on the card."""
    fig = serial.alg1_truss(12, fig2)
    k, c = np.unique(fig, return_counts=True)
    if dict(zip(k.tolist(), c.tolist())) != FIG2_CLASSES or \
            not np.array_equal(fig, serial.alg2_truss(12, fig2)):
        raise AssertionError("6: alg1_truss differs on the Figure-2 graph")
    n13, e13 = rmat(13, 8, seed=5)
    t0 = time.perf_counter()
    phi_a1 = serial.alg1_truss(n13, e13)
    a1_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    phi_a2 = serial.alg2_truss(n13, e13)
    a2_s = time.perf_counter() - t0
    check_digest("rmat13", phi_a1)
    if not np.array_equal(phi_a1, phi_a2):
        raise AssertionError("6: alg1_truss and alg2_truss differ on rmat13")
    tag = "6 in-memory rmat13"
    phi_card = run_phase(tag, lambda: truss_decompose(n13, e13, device=dev))
    if not np.array_equal(phi_card, phi_a1):
        raise AssertionError("6: truss_decompose on the card differs from "
                             "alg1_truss on rmat13")
    card_s = phase_walls[tag]
    say(f"[6] Table 3 on rmat13 (n={n13}, m={len(phi_a1)}): alg1_truss "
        f"(TD-inmem, host) {a1_s:.3f} s, alg2_truss (TD-inmem+, host) "
        f"{a2_s:.3f} s, truss_decompose in-memory on the card {card_s:.3f} "
        f"s; {smi}")
    edge_set = lambda e: set(map(tuple, np.asarray(e).tolist()))
    kmax17 = int(phi17.max())
    t17 = serial.truss_from_phi(canonical_edges(e17, n17), phi17, kmax17)
    if edge_set(t17) != edge_set(kmax_truss17) or \
            len(t17) != MAINT_DIGESTS["8c"]["et"]:
        raise AssertionError("6: truss_from_phi at k_max on rmat17 differs "
                             "from 8c's k_max-truss")
    kmax13, t13_card = kmax_truss(n13, e13, device=dev)
    t13 = serial.truss_from_phi(canonical_edges(e13, n13), phi_a1, kmax13)
    if kmax13 != DIGESTS["rmat13"]["kmax"] or \
            edge_set(t13) != edge_set(t13_card):
        raise AssertionError("6: truss_from_phi of alg1's phi differs from "
                             "kmax_truss on the card on rmat13")
    say(f"[6] alg1_truss equals alg2_truss and the JAX digest on rmat13 and "
        f"the Figure-2 classes; truss_from_phi at k_max: rmat17 {len(t17)} "
        f"edges (k={kmax17}) equal to 8c's k_max-truss, rmat13 {len(t13)} "
        f"(k={kmax13}) equal to kmax_truss on the card")
    return dict(m=len(phi_a1), alg1_s=a1_s, alg2_s=a2_s, card_s=card_s,
                kmax_truss_rmat17=len(t17), kmax_truss_rmat13=len(t13))


# phase 15's children: one example of the port each, run as a script with
# jax and repro blocked (a stray import fails), then the kernel launches it
# made in its own process
EXAMPLE_CHILD = r"""
import json, runpy, sys
sys.modules["jax"] = None
sys.modules["repro"] = None
from repro_torch.kernels.embedding_bag import kernel as bk
from repro_torch.kernels.flash_attention import kernel as ak
from repro_torch.kernels.frontier_peel import kernel as fk
from repro_torch.kernels.triangle_count import kernel as tk
sys.argv = sys.argv[1:]
runpy.run_path(sys.argv[0], run_name="__main__")
print("[launches] " + json.dumps({"B1": fk.LAUNCHES, "B2": tk.LAUNCHES,
                                  "B3": ak.LAUNCHES, "B4": bk.LAUNCHES}))
"""
EXAMPLES = ("quickstart_torch", "truss_analysis_torch", "serve_lm_torch",
            "train_lm_torch", "train_gnn_truss_torch")
EXAMPLES_TIMEOUT_S = 600
TRAIN_EXAMPLE_STEPS = 20


def check_example(name: str, lines: list, launches: dict) -> dict:
    """What phase 15 holds each example's output to."""
    num = r"(-?[0-9.]+|nan|inf)"
    if name == "quickstart_torch":
        if tuple(lines) != QUICKSTART_LINES or not launches["B1"]:
            raise AssertionError(f"15: quickstart_torch printed {lines}, B1 "
                                 f"{launches['B1']}")
        return {}
    if name == "truss_analysis_torch":
        if tuple(lines) != TRUSS_ANALYSIS_LINES or not launches["B1"]:
            raise AssertionError(f"15: truss_analysis_torch printed {lines}, "
                                 f"B1 {launches['B1']}")
        return {}
    if name == "serve_lm_torch":
        m = re.fullmatch(r"\[serve\] gemma3-4b on cuda: 8 requests, prefill "
                         r"32 toks in [0-9.]+ ms, 16 decode steps in [0-9.]+ "
                         r"ms \(([0-9]+) tok/s\)", lines[0]) \
            if len(lines) == 2 else None
        toks = json.loads(lines[1].split(": ", 1)[1]) if m else []
        if not m or len(toks) != 16 or not lines[1].startswith(
                "[serve] first request generation: "):
            raise AssertionError(f"15: serve_lm_torch printed {lines}")
        return dict(tokens_per_s=int(m.group(1)))
    if name == "train_lm_torch":
        m = [re.fullmatch(rf"\[train\] qwen2.5-14b: loss {num} -> {num} over "
                          rf"{TRAIN_EXAMPLE_STEPS} steps", x) for x in lines]
        m = [x for x in m if x]
        if not m or not lines[0].endswith("on cuda") or not all(
                np.isfinite(float(v)) for v in m[0].groups()):
            raise AssertionError(f"15: train_lm_torch printed {lines}")
        return dict(loss_first=float(m[0].group(1)),
                    loss_last=float(m[0].group(2)))
    m = re.fullmatch(rf"GraphSAGE final loss — uniform sampling: {num}, "
                     rf"truss-weighted sampling: {num}", lines[0]) \
        if len(lines) == 1 else None
    if not m or not all(np.isfinite(float(v)) for v in m.groups()):
        raise AssertionError(f"15: train_gnn_truss_torch printed {lines}")
    return dict(loss_uniform=float(m.group(1)),
                loss_weighted=float(m.group(2)))


def examples_phase(run_phase) -> dict:
    """Phase 15: the five port examples (``examples/*_torch.py``) as child
    processes on the card, all started together, each importing neither
    ``jax`` nor ``repro`` (both blocked); each must exit 0 and print what
    ``check_example`` holds it to; ``train_lm_torch`` takes
    ``--steps TRAIN_EXAMPLE_STEPS`` and a checkpoint directory of its own.
    Every child is killed at ``EXAMPLES_TIMEOUT_S``.  The children's kernel
    launches are their own (printed, B1 required of the two truss
    examples); this process launches nothing."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               PYTHONIOENCODING="utf-8")
    out: dict = {}

    def run():
        with tempfile.TemporaryDirectory(prefix="chip_smoke_ex_") as d:
            procs = {}
            try:
                for name in EXAMPLES:
                    args = [str(ROOT / "examples" / f"{name}.py")]
                    if name == "train_lm_torch":
                        args += ["--steps", str(TRAIN_EXAMPLE_STEPS),
                                 "--ckpt-dir", os.path.join(d, "ckpt")]
                    log = open(os.path.join(d, f"{name}.out"), "w+",
                               encoding="utf-8")
                    procs[name] = (subprocess.Popen(
                        [sys.executable, "-c", EXAMPLE_CHILD, *args],
                        env=env, stdout=log, stderr=subprocess.STDOUT,
                        cwd=d), log, time.perf_counter())
                deadline = time.perf_counter() + EXAMPLES_TIMEOUT_S
                walls = {}
                while len(walls) < len(procs):
                    if time.perf_counter() > deadline:
                        raise AssertionError(
                            f"15: {sorted(set(procs) - set(walls))} still "
                            f"running after {EXAMPLES_TIMEOUT_S} s")
                    for name, (p, _, t0) in procs.items():
                        if name not in walls and p.poll() is not None:
                            walls[name] = time.perf_counter() - t0
                    time.sleep(0.1)
            finally:
                for p, log, _ in procs.values():
                    if p.poll() is None:
                        p.kill()
                        p.wait()
                    log.close()
            for name, (p, log, _) in procs.items():
                with open(log.name, encoding="utf-8") as f:
                    text = f.read()
                if p.returncode != 0:
                    raise AssertionError(f"15: {name} exited "
                                         f"{p.returncode}:\n{text[-4000:]}")
                lines = text.splitlines()
                launches = json.loads(lines[-1].split(" ", 1)[1])
                lines = [x for x in lines[:-1]
                         if not x.startswith(("  {", "   {"))]
                out[name] = dict(wall_s=round(walls[name], 3),
                                 launches=launches,
                                 **check_example(name, lines, launches))
                say(f"[15] {name}: exit 0, wall {walls[name]:.3f} s, "
                    f"launches in its process {launches}; "
                    f"{lines[-1][:160]}")

    run_phase("15 examples", run)
    return out


def main(argv) -> int:
    import torch
    import torch.distributed as tdist
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
    from repro_torch.core.peel import (estimate_working_set, kmax_truss,
                                       peel_recompute, truss_decompose)
    from repro_torch.core.bottom_up import bottom_up_decompose
    from repro_torch.core import distributed as rdist
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
    from repro_torch.kernels.decode_attention import kernel as dk
    from repro_torch.kernels.decode_attention import ref as dref
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
    b5_build = b5_build_check(build)
    # phase 13's dry runs trace on the host while phases 2-12 use the card
    dry_tmp = tempfile.mkdtemp(prefix="chip_smoke_dry_")
    dry = start_dryruns(dry_tmp)
    oracles = start_dense_oracles(dry_tmp)
    atexit.register(shutil.rmtree, dry_tmp, True)
    atexit.register(stop_dryruns, dry)

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
    b5 = b5_phase(torch, F, dk, dref, gen, dev)
    b5["build"] = {f"{f} {dt} {g}": r for (f, dt, g), r in b5_build.items()}

    # -- truss path: phases 3-5 ----------------------------------------------
    kernel_mods = {"B1": fk, "B2": tk, "B3": ak, "B4": bk, "B5": dk}

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
            rdev.reset_counters()   # the serving path's, of this phase only
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
            rdev.reset_counters()   # unread: free the phase's MoE masks
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

    # 5c, after the counts: B2's S of the dense core against the host oracles
    (A,), kw = p2.largest[None]
    dense_core = dense_core_check(torch, tk, tref, build_graph, A, kw,
                                  oracles)
    if dense_core["m"] != DIGESTS["er2048"]["m"]:
        raise AssertionError(f"5c: the dense core has {dense_core['m']} "
                             f"edges, er2048 {DIGESTS['er2048']['m']}")
    del A

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
    maint["table6"], kmax_truss17 = table6(
        core_decompose, cmax_core, clustering_coefficient, incident_vertices,
        canonical_edges, run_phase, n17, e17, phi17, dev)
    maint["global_iterate"] = global_iterate(peel_recompute, list_triangles,
                                             run_phase, rdev, g15, phi15, dev)
    maint["perpart"] = perpart(bottom_up_decompose, estimate_working_set,
                               build_graph, rmat, run_phase, dev)
    if any(c[k] for t, c in phase_launches.items() if t.startswith("8")
           for k in ("B2", "B3", "B4")):
        raise AssertionError("phases 8a-8e launched B2, B3 or B4")
    say(f"[8a-8e] {json.dumps(maint)}")

    # -- phase 9: the mesh paths: one NCCL rank here, two gloo ranks --------
    zero_counts()
    pmesh = b1_probe(torch, fk)
    mesh = mesh_one_rank(torch, tdist, rdist, tk, truss_decompose,
                         truss_maintain, estimate_working_set, build_graph,
                         rmat, run_phase, phase_launches, n15, e15, budget,
                         phi15, phi15, 2048, e_er, dev)
    mesh_host_ms = pmesh.close()
    mesh_tags = [t for t in phase_launches if t.startswith("9a")]
    mesh_launches = sum(phase_launches[t]["B1"] for t in mesh_tags)
    if fk.LAUNCHES != mesh_launches or len(pmesh.events) != mesh_launches:
        raise AssertionError("9a: launch counters disagree with the calls "
                             "seen")
    mesh_rows = b1_rows(torch, pmesh)
    (sup, alive, rm, tris, n_rows), _ = pmesh.largest[None]
    args = (sup, alive, rm, tris)
    B, E, T = sup.shape[0], sup.shape[1], tris.shape[1]
    rw = check_b1_live(torch, fk, fref, args, n_rows,
                       f"on 9a's largest call (B={B} E={E} T={T})")
    t_out, n_out = torch.empty_like(tris), torch.empty_like(n_rows)
    b1_mesh = dict(
        launches=mesh_launches, shape=[B, E, T],
        max_abs_err=rw.pop("max_abs_err"),
        ms=time_ms(torch, lambda: fk.fused_round_live(
            *args, n_rows, t_out, n_out), 50),
        plain_ms=time_ms(torch, lambda: fref.fused_round_live(
            *args, n_rows), 10),
        bound_ms=b1_bound_ms(B, E, rw["rows_read"], rw["rows_written"]),
        **rw, total_host_inclusive_ms=mesh_host_ms,
        total_bound_ms=mesh_rows["bound_ms"],
        path_rows_read=mesh_rows["rows_read"],
        path_rows_written=mesh_rows["rows_written"])
    if profile:
        b1_mesh["total_ms"] = sum(
            ns / 1e6 for t in mesh_tags
            for nm, (ns, _) in phase_trace[t].items() if B1_TRACE_NAME in nm)
    say(f"[9a] B1 over the mesh path: {b1_mesh}")
    del sup, alive, rm, tris, args, t_out, pmesh
    mesh["two_ranks"] = mesh_two_ranks(run_phase)
    say(f"[9a-9c] {json.dumps(mesh)}")

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
    table3 = algorithm1_phase(serial, truss_decompose, kmax_truss,
                              canonical_edges, rmat, run_phase, phase_walls,
                              fig2, n17, e17, phi17, kmax_truss17, smi, dev)
    del kmax_truss17
    say(f"[6] {json.dumps(dict(table3=table3, dense_core_5c=dense_core))}")
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
    lm_launches = {"flash_attention": ak.LAUNCHES,
                   "decode_attention": dk.LAUNCHES}
    b3_ms = p3.close()
    if fk.LAUNCHES or tk.LAUNCHES or bk.LAUNCHES:
        raise AssertionError("the LM path launched B1, B2 or B4")
    if ak.LAUNCHES != cfg.n_layers or len(p3.events) != ak.LAUNCHES:
        raise AssertionError(f"B3 launched {ak.LAUNCHES} times in one "
                             f"prefill of {cfg.n_layers} layers")
    b5_want = b5_launches(dk, cfg, n_req, max_seq, new_tokens)
    if dk.LAUNCHES != b5_want:
        raise AssertionError(f"B5 launched {dk.LAUNCHES} times in "
                             f"{new_tokens} decode steps of {cfg.n_layers} "
                             f"layers, not {b5_want}")
    say(f"[7] {n_req} requests x {prompt_len} prompt tokens: prefill wall "
        f"{gen_out.prefill_s * 1e3:.1f} ms; {new_tokens} decode steps in "
        f"{gen_out.decode_s * 1e3:.1f} ms = "
        f"{n_req * new_tokens / gen_out.decode_s:.1f} tokens/s; B3 "
        f"{ak.LAUNCHES} launches, {b3_ms:.3f} device ms in its calls "
        f"(summed bounds {p3.bound_ms:.3f} ms); B5 {dk.LAUNCHES} launches; "
        f"first request's tokens {gen_out.tokens[0, :8].tolist()}...")
    flash_logits = gen_out.prefill_logits.float()
    if gen_out.tokens.shape != (n_req, new_tokens) or \
            flash_logits.shape != (n_req, cfg.vocab) or \
            not bool(torch.isfinite(flash_logits).all()):
        raise AssertionError("phase 7 output has the wrong shape or is not "
                             "finite")
    plain_cfg = dataclasses.replace(cfg, use_flash_kernel=False)
    t0 = time.perf_counter()
    # the logits alone: a cache kept alive here would crowd phase 7b
    plain_logits = lm.prefill(params, prompts, plain_cfg, max_seq=max_seq,
                              device=dev)[1].float()
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
        alt = lm.prefill(params, prompts, dataclasses.replace(
            plain_cfg, window=window), max_seq=max_seq, device=dev)[1]
        d_alt = (alt.float() - plain_logits).abs()
        say(f"[7] plain path with {label}: last-token logits move by "
            f"{float(d_alt.max()):.4f} at most, mean {float(d_alt.mean()):.5f}"
            f"; within LOGITS_TOL: "
            f"{bool(torch.allclose(alt.float(), plain_logits, **LOGITS_TOL))}")
        del alt, d_alt
    del params, gen_out, flash_logits, plain_logits, diff

    # -- phases 7b-7d: MoE serving at full width (phase 7's traffic) --------
    moe, moe_probes, moe_cfgs = {}, {}, {}
    for tag, arch, n_layers in MOE_SERVE:
        cfg = dataclasses.replace(registry.get_config(arch),
                                  use_flash_kernel=True)
        if n_layers is not None:
            cfg = dataclasses.replace(cfg, n_layers=n_layers)
        moe_cfgs[tag] = cfg
        moe[tag], moe_probes[tag], got = moe_serve(
            torch, lm, serve, cfg, tag, run_phase, zero_counts,
            phase_launches, ak, dev, keep_layer0=tag == "7b")
        if got is not None:
            layer0 = got
    moe["7d"] = moe_layer_check(torch, lm, moe_cfgs["7b"], *layer0, dev)
    del layer0
    say(f"[7b-7d] {json.dumps(moe)}")

    # -- phase 10: training, once phases 7-7d's parameters are freed ------
    train = train_phases(torch, run_phase, phase_launches, dev)
    say(f"[10] {json.dumps(train)}")

    # -- phases 11 and 12: DIN (B4's path) and the GNNs at full width -------
    din = din_phases(torch, run_phase, phase_launches, bk, bref, dev)
    say(f"[11] {json.dumps(din)}")
    gnn = gnn_phases(torch, run_phase, phase_launches, n15, e15, phi15, dev)
    say(f"[12] {json.dumps(gnn)}")

    # -- phase 13: the cell and dry-run layer --------------------------------
    t13 = time.perf_counter()
    cells13 = {"13a": dryrun_phase(run_phase, dry)}
    cells13["13b"] = cell_runs(torch, run_phase, phase_launches, dry, dev)
    cells13["13c"] = ring_phases(torch, run_phase, phase_launches, dev)
    stop_dryruns(dry)
    cells13["wall_s"] = time.perf_counter() - t13
    say(f"[13] wall {cells13['wall_s']:.1f} s; {json.dumps(cells13)}")

    # -- phase 14: the static-analysis pass and shared memory ------------------
    b1_E = max((E for _, E, *_ in p1.notes), key=fk.smem_bytes)
    static14 = {"14a": trusscheck_phase(run_phase),
                "14b": smem_phase(torch, run_phase, build, fk, tk, ak, bk,
                                  dk, b1_E, smi)}
    if any(n for tag in ("14a trusscheck", "14b shared memory")
           for n in phase_launches[tag].values()):
        raise AssertionError("phase 14 launched a kernel")
    say(f"[14] {json.dumps(static14)}")

    # -- phase 15: the port's examples as child processes on the card -------
    torch.cuda.empty_cache()
    t15 = time.perf_counter()
    examples = examples_phase(run_phase)
    if any(phase_launches["15 examples"].values()):
        raise AssertionError("phase 15 launched a kernel in this process")
    say(f"[15] wall {time.perf_counter() - t15:.1f} s; "
        f"{json.dumps(examples)}")

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
        launches=launches["frontier_peel"] + maint_launches + mesh_launches,
        launches_by_path={"truss (3-5d)": launches["frontier_peel"],
                          "maintenance (8a)": maint_launches,
                          "mesh (9a)": mesh_launches},
        max_abs_err=max(err, b1_maint["max_abs_err"],
                        b1_mesh["max_abs_err"]),
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
        mesh=b1_mesh,
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
        ms, turns = time_turns(torch, lambda: ak.flash_attention(
            q, k, v, window=window), 5, B3_TURNS)
        row = dict(
            name="flash_attention.flash_attention", route="cuda",
            source="src/repro_torch/csrc/flash_attention.cu",
            replaces="src/repro/kernels/flash_attention/kernel.py:101",
            launches=lm_launches["flash_attention"],
            max_abs_err=check_b3(q, k, v, window),
            ms=ms, ms_turns=turns,
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
            f"{err32:.3g}; kernel {row['ms']:.4f} ms (median of "
            f"{B3_TURNS} turns, {min(turns):.4f}-{max(turns):.4f}), plain "
            f"{row['plain_ms']:.4f} ms, "
            f"sdpa {row['library_ms']:.4f} ms, bound {bound:.4f} ms ({by})")
        b3_rows.append(row)
    by_window = [{k: r[k] for k in ("window", "max_abs_err", "float32_err",
                                    "ms", "ms_turns", "plain_ms", "library_ms",
                                    "bound_ms")} for r in b3_rows]
    # B3 at D = 128 on the MoE paths: the largest call of 7b (MHA) and of 7c
    # (GQA, group 4); every call of a path has its shape.  bf16, and upcast
    # to float32 (strides kept)
    d128 = {}
    for t, probe in moe_probes.items():
        (q, k, v), _ = probe.largest[None]
        bound, by = b3_bound(q, k, None)
        ms, turns = time_turns(torch, lambda: ak.flash_attention(q, k, v), 5,
                               B3_TURNS)
        d128[t] = row = dict(
            shape=[*q.shape, k.shape[1]], strides=list(q.stride()),
            max_abs_err=check_b3(q, k, v, None),
            float32_err=check_b3(q.float(), k.float(), v.float(), None),
            ms=ms, ms_turns=turns,
            plain_ms=time_ms(torch, lambda: aref.mha_reference(q, k, v), 3),
            library_ms=time_ms(torch, lambda: sdpa(q, k, v, None), 5),
            bound_ms=bound, bound_by=by, launches=moe[t]["b3_launches"],
            total_ms=moe[t]["b3_ms"], total_bound_ms=moe[t]["b3_bound_ms"])
        say(f"[{t}] B3 on the path's largest call {row['shape']} strides "
            f"{row['strides']}: max abs err bf16 {row['max_abs_err']:.3g}, "
            f"float32 {row['float32_err']:.3g}; kernel {row['ms']:.4f} ms "
            f"(median of {B3_TURNS} turns, {min(turns):.4f}-"
            f"{max(turns):.4f}), plain "
            f"{row['plain_ms']:.4f} ms, sdpa {row['library_ms']:.4f} ms, "
            f"bound {bound:.4f} ms ({by}); {row['launches']} calls "
            f"{row['total_ms']:.3f} device ms (summed bounds "
            f"{row['total_bound_ms']:.3f} ms)")
        del q, k, v
    del moe_probes
    b3_paths = {"gemma3-4b (7)": lm_launches["flash_attention"],
                **{f"{moe_cfgs[t].name} ({t})": moe[t]["b3_launches"]
                   for t in moe_cfgs}}
    b3 = max(b3_rows, key=lambda r: r["bound_ms"])
    b3.update(launches=sum(b3_paths.values()), launches_by_path=b3_paths,
              max_abs_err=max(r["max_abs_err"]
                              for r in b3_rows + list(d128.values())),
              d128=d128,
              total_ms=b3_ms, total_bound_ms=p3.bound_ms,
              by_window=by_window, design=B3_DESIGN, bf16_d256=b3_tc[256],
              bf16_d128=b3_tc[128])
    kernels.append(b3)
    # B4 on its DIN path (phases 11a-11c): the line's numbers are the
    # path's largest call (11b's history lookup on item_emb, bags of one
    # row, sum) against torch.index_select; phase 2's serve_bulk bags of 100
    # (mean, against F.embedding_bag) are kept beside them
    l100 = {k: b4.pop(k) for k in (
        "shape", "mode", "max_abs_err", "ms", "plain_ms", "bound_ms",
        "library_ms", "graph_ms", "gather_floor_ms",
        "traffic_derived_from_shapes")}
    b4.pop("note")
    big = din["11b"]["b4_calls"][0]
    b4_paths = {"din serve_p99 (11a)": din["11a"]["b4_launches"],
                "din serve_bulk (11b)": din["11b"]["b4_launches"],
                "din retrieval_cand (11c)": din["11c"]["b4_launches"],
                "din cells (13b)": sum(v["b4_launches"] for v in
                                       cells13["13b"].values())}
    b4.update(
        launches=sum(b4_paths.values()), launches_by_path=b4_paths,
        max_abs_err=max(max(c["max_abs_err"] for c in din["11b"]["b4_calls"]),
                        l100["max_abs_err"]),
        ms=big["ms"], plain_ms=big["plain_ms"], bound_ms=big["bound_ms"],
        library_ms=big["library_ms"], library="torch.index_select",
        shape=[big["V"], DIN_D, big["bags"], big["L"]], mode="sum",
        entry=big["entry"],
        path_calls=din["11b"]["b4_calls"],
        path_event_ms=din["11b"]["b4_event_ms"],
        path_bound_ms=din["11b"]["b4_bound_ms"],
        serve_bulk_l100=dict(l100, library="F.embedding_bag"))
    say(f"[11] B4 on DIN's path: launches {b4_paths}; on the path's largest "
        f"call {b4['shape']} (V, D, bags, L), {b4['entry']} entry: kernel "
        f"{b4['ms']:.4f} ms, "
        f"plain {b4['plain_ms']:.4f} ms, index_select "
        f"{b4['library_ms']:.4f} ms, bound {b4['bound_ms']:.4f} ms (bytes)")
    kernels.append(b4)
    # B5 on the decode paths (phases 7-7c): phase 2's rows at the b160
    # cell's and gemma3-4b's layer shapes
    b5_paths = {"gemma3-4b (7)": lm_launches["decode_attention"],
                **{f"{moe_cfgs[t].name} ({t})": moe[t]["b5_launches"]
                   for t in moe_cfgs}}
    b5.update(launches=sum(b5_paths.values()), launches_by_path=b5_paths)
    say(f"[7] B5 on the decode paths: launches {b5_paths}; at the b160 "
        f"layer kernel {b5['ms']:.4f} ms, plain {b5['plain_ms']:.4f} ms, "
        f"sdpa {b5['library_ms']:.4f} ms, bound {b5['bound_ms']:.4f} ms "
        f"({b5['bound_by']})")
    kernels.append(b5)
    say(f"[all] wall {time.perf_counter() - t_all:.1f} s; {smi}")
    say(json.dumps({"kernels": kernels}))
    say(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
