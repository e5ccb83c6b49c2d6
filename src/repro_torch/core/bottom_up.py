"""Bottom-up I/O-efficient truss decomposition (paper Section 5, Alg 3-5).

Port of the batched engine of ``repro.core.bottom_up``.

Stage 1 — ``lower_bounding`` (Algorithm 3): partition the working graph into
parts whose neighbourhood subgraphs fit the budget and decompose every
NS(P) locally; Lemma 1 makes the local trussness a lower bound of phi(e).
Internal edges leave the working graph after each round (to ``G_new``) and
the loop repeats on the remainder.  One round is one
:class:`partition.PartitionBatch`: every bucket of lanes peels in lockstep
through the fused round kernel (``peel.peel_classes_batched``).  Rounds are
double-buffered: a round's internal edges are known when its batch is
built, so the producer builds round r + 1 before round r's results are
consumed, one round late.

Stage 2 — ``bottom_up_decompose`` (Algorithm 4 + Procedure 5): for
ascending k, the candidate H = NS(U_k), U_k the endpoints of undecided edges
with lb <= k, is compacted and peeled at threshold k - 2
(``peel.local_threshold_peel``); the removed internal edges are Phi_k.
Level k+1's candidate is pre-built from the masks before level k's result
is read (a superset of U_{k+1}, which is sound); the edges level k removed
are then killed through the peel's ``alive0`` mask.

``partitioned_support`` is the triangle-credit variant of stage 1 that the
budgeted top-down driver uses: exact supports of the whole graph under the
budget, on the host.

Resilience (as in the reference): a :class:`RoundJournal` snapshots the
host-side state after completed rounds ("lb", "sup") and levels ("s2");
``resume=True`` continues from the newest intact snapshot to the phi of an
uninterrupted run.  A retryable device failure (``faults.is_retryable``:
out of memory) walks a retry ladder — lane splits, then a restart of the
rounds at half the budget — and anything else propagates.

Deviation from the paper (as in the reference): Phi_2 is flagged exactly
only in round 1 (later rounds measure supports on the shrunk working graph)
and stage 2 starts at k = 2.

With a graph store (``store=``, ``core.store``) the round loop spills the
working graph and its triangle list between rounds: each successor graph
is spilled chunk-wise (untouched chunks alias the predecessor's files),
the predecessor released, and the next round's arrays prefetched before the
yield, so the store's reads overlap the device peel.  The locality
partitioner's zone state (the previous round's capture) is journaled with
each stage-1 snapshot and restored on resume.

``engine="perpart"`` is the reference's per-part seed baseline, kept as a
second implementation and a benchmark yardstick: every round rebuilds the
working graph, and every part (stage 1) and level (stage 2) is built over
the full vertex space, listed on the host and peeled by the in-memory
engines (``peel.peel_classes`` / ``peel.peel_threshold``), with no journal,
store or retry ladder.

With a ``mesh`` (a ``torch.distributed`` device mesh; every rank runs the
same call on the same inputs) each stage-1 bucket's lanes are split over
the lane axis and every stage-2 level peel is triangle-sharded
(``core.distributed``); the batches are packed waste-aware for the lane
count (``partition.build_partition_batch``'s ``lane_multiple`` and shape
ladder).  The ranks agree on every dispatch's outcome, so they take the
same rung of a ladder; its mesh-drop rung finishes the run single-device
on every rank, and the ranks still agree on each of those dispatches, so
they stay in step to the end.  Rank 0 alone writes the journal (its clock
decides a time-gated snapshot for every rank); every rank reads it on
resume, after a barrier.
"""

from __future__ import annotations

import contextlib
import dataclasses
import hashlib
import re
import time
import warnings
from typing import Callable, Dict, Iterator, List, Optional, Tuple, Union

import numpy as np

import torch.distributed as tdist

from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import distributed as dist_lib
from repro_torch.core import faults
from repro_torch.core import graph as glib
from repro_torch.core import partition as plib
from repro_torch.core import support as sup_lib
from repro_torch.core.peel import (PendingPeel, local_threshold_peel,
                                   peel_classes, peel_classes_batched,
                                   peel_threshold)
from repro_torch.core.store import GraphStore
from repro_torch.core.support import (list_triangles,
                                      support_from_triangle_list)
from repro_torch.device import (host_array, release_cached_blocks,
                                resolve_device)
from repro_torch.kernels import check_kernel

# The degradation ladder's floor for the per-round working-set budget:
# halving below this cannot meaningfully shrink a dispatch, so at the floor
# the failure propagates.
_MIN_ROUND_BUDGET = 64


class _RestartRounds(Exception):
    """Control flow of the stage-1 degradation ladder: unwind the round
    generator and restart it from the host state with a smaller budget
    (smaller parts, smaller dispatches).  Completed rounds' folds are
    idempotent scatters, so a restart loses at most the failed round's
    device work."""

    def __init__(self, budget: int):
        super().__init__(f"restart partition rounds at budget={budget}")
        self.budget = budget


@dataclasses.dataclass
class _Engine:
    """Dispatch configuration shared by a run's device launches.  The
    ladders' mesh-drop rung rewrites it in place (``mesh = None``), so every
    later dispatch, stage 2's included, runs single-device.  ``group`` is
    the run's ranks (None without a mesh); it outlives the drop, so the
    ranks go on agreeing on every dispatch (:func:`_dispatch`)."""

    kernel: str = "auto"
    device: object = None
    mesh: object = None
    mesh_axis: object = "data"   # one axis name or a (lane, tri) pair

    def __post_init__(self):
        self.group = (None if self.mesh is None
                      else dist_lib.mesh_group(self.mesh))

    @property
    def n_dev(self) -> int:
        """Lane-axis size: the multiple the bucket packing pads lanes to."""
        if self.mesh is None:
            return 1
        ax = self.mesh_axis
        return dist_lib.axis_size(self.mesh, ax if isinstance(ax, str)
                                  else ax[0])

    @property
    def devices(self) -> int:
        """Devices spanned: the product over every named mesh axis."""
        return dist_lib.mesh_devices(self.mesh, self.mesh_axis)


def _dispatch(eng: _Engine, mesh, dispatch) -> PendingPeel:
    """``dispatch()``'s non-blocking handle, where ``mesh`` is the mesh the
    call was given.  A call of a mesh run that goes single-device (a retry's
    sub-bucket whose lanes do not divide the lane axis, or any call after
    the mesh drop) still has its dispatch and its finalize agreed on over
    the run's ranks, so a failure on one rank sends every rank to the same
    rung.  A mesh call agrees on its own."""
    if mesh is not None or eng.group is None:
        return dispatch()
    h = dist_lib.agreed(eng.group, dispatch)
    return PendingPeel(h.result, h.new_compile,
                       agree=lambda err: dist_lib.agree(err, eng.group))


def _agreed(eng: _Engine, fn):
    """``fn()``, with its outcome agreed on over a mesh run's ranks."""
    return fn() if eng.group is None else dist_lib.agreed(eng.group, fn)


class _AdaptiveLocality:
    """The locality partitioner with its feedback: ``_partition_rounds``
    calls :meth:`observe` with each built batch, and the next round's zone
    scales with the capture that round achieved (``partition._zone_mult``).
    """

    def __init__(self, fn):
        self._fn = fn
        self.prev_locality: float | None = None

    def __call__(self, g, budget, round_idx):
        return self._fn(g, budget, prev_locality=self.prev_locality)

    def observe(self, batch: plib.PartitionBatch) -> None:
        if batch.tri_total:
            self.prev_locality = batch.tri_locality


def _zone_state(part_fn):
    """The partitioner's state for a journal snapshot: the locality
    partitioner's previous capture (a float), None for the stateless ones.
    Without it a resumed run would plan its rounds from the cold default
    (phi equal, rounds and counters not)."""
    state = getattr(part_fn, "prev_locality", None)
    return None if state is None else float(state)


def _restore_zone_state(part_fn, state) -> None:
    """Reinstall a journaled :func:`_zone_state` into the partitioner."""
    if state is not None and hasattr(part_fn, "prev_locality"):
        part_fn.prev_locality = float(state)


def _resolve_partitioner(partitioner: str, seed: int = 0):
    """Normalize a partitioner name to fn(graph, budget, round_idx) -> parts.

    The randomized partitioner is re-seeded every round (``seed + round``):
    Chu–Cheng's guarantee that crossing edges eventually co-locate holds
    only under re-randomization.  "locality" gives a fresh
    :class:`_AdaptiveLocality` per call, so its feedback stays in one run.
    """
    if partitioner not in plib.PARTITIONERS:
        raise ValueError(f"unknown partitioner {partitioner!r}; expected one "
                         f"of {sorted(plib.PARTITIONERS)}")
    fn = plib.PARTITIONERS[partitioner]
    if partitioner == "random":
        return lambda g, b, r: fn(g, b, seed=seed + r)
    if partitioner == "locality":
        return _AdaptiveLocality(fn)
    return lambda g, b, r: fn(g, b)


@dataclasses.dataclass
class OocStats:
    """Work counters of one out-of-core run.

    The integer counters are defined as in ``repro.core.bottom_up.OocStats``
    (``compiles`` counts distinct launch shapes here, there being no XLA
    compile).  The ``*_s`` fields are host wall-clock seconds: building the
    stage-1 partition batches (partitioning, triangle routing, lane packing,
    graph maintenance), building the stage-2 / top-down candidates
    (extraction, compaction, triangle listing), and the device peels
    (dispatch to result).
    """

    rounds: int = 0           # partition rounds (the paper's O(m/M) scans)
    scans: int = 0            # NS/candidate extractions (I/O-scan analogue)
    batches: int = 0          # device peels (one per bucket per round/level)
    compiles: int = 0         # distinct launch shapes of this run
    parts: int = 0            # NS parts processed
    max_part_edges: int = 0   # largest NS working set seen (budget check)
    real_edges: int = 0       # sum of real edge slots across all batches
    padded_slots: int = 0     # sum of materialized lane slots
    tri_total: int = 0        # triangles enumerated across partition rounds
    tri_assigned: int = 0     # of those, captured inside some part
    ns_sweeps: int = 0        # whole-graph NS edge-list sweeps (1 per batch)
    overlapped: int = 0       # rounds built while the previous was pending
    stage2_overlapped: int = 0  # levels whose candidate was pre-built
    tri_est: int = 0          # wedge-based triangle estimates, summed
    tri_rescans_avoided: int = 0  # rounds that filtered the previous
    #                           round's triangle list instead of listing
    devices: int = 1          # mesh devices a dispatch spans
    sharded_rounds: int = 0   # dispatches across the mesh (stage-1 rounds
    #                           and level peels)
    retries: int = 0          # failed dispatches re-driven by a ladder
    degraded: int = 0         # degradations taken (budget halvings)
    checkpoints: int = 0      # journal snapshots written this run
    resumed_round: int = -1   # round/level of the snapshot this run resumed
    #                           from (-1: started fresh)
    chunk_reads: int = 0      # graph-store chunks read back
    chunk_writes: int = 0     # graph-store chunks written
    bytes_spilled: int = 0    # bytes written; aliased chunks cost 0
    prefetch_hits: int = 0    # chunk requests served by a scheduled read
    prefetch_misses: int = 0  # chunk requests read synchronously
    tri_spill_rows: int = 0   # largest triangle list (rows) spilled
    tri_reload_peak_rows: int = 0  # most triangle rows held at once while
    #                           reading a spilled list back
    edits_applied: int = 0    # maintenance edits applied (core.maintain)
    maintain_levels: int = 0  # per-level region peels run by maintenance
    affected_edges: int = 0   # candidate edges summed over those levels
    round_build_s: float = 0.0      # host: stage-1 batch building
    candidate_build_s: float = 0.0  # host: candidate building
    peel_s: float = 0.0             # device peels, dispatch to result

    @property
    def prefetch_hit_rate(self) -> float:
        """Share of chunk requests whose read the prefetch thread had
        already scheduled."""
        total = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / total if total else 1.0

    @property
    def tri_routes(self) -> int:
        """Whole-graph triangle routings to parts: ``build_partition_batch``
        routes the triangles once per NS sweep, so this is ``ns_sweeps``."""
        return self.ns_sweeps

    @property
    def padding_waste(self) -> float:
        if not self.padded_slots:
            return 0.0
        return 1.0 - self.real_edges / self.padded_slots

    @property
    def tri_locality(self) -> float:
        return self.tri_assigned / self.tri_total if self.tri_total else 1.0

    @property
    def tri_est_error(self) -> float:
        return abs(self.tri_est - self.tri_total) / max(self.tri_total, 1)

    def absorb_batch(self, batch: plib.PartitionBatch) -> None:
        self.parts += batch.n_parts
        self.scans += batch.n_parts
        self.batches += len(batch.buckets)
        self.real_edges += batch.real_edges
        self.padded_slots += batch.padded_slots
        self.max_part_edges = max(self.max_part_edges, batch.max_part_edges)
        self.tri_total += batch.tri_total
        self.tri_assigned += batch.tri_assigned
        self.tri_est += batch.tri_est
        self.ns_sweeps += 1

    def as_dict(self) -> Dict[str, Union[int, float]]:
        """JSON-safe snapshot of every field (the journal's metadata)."""
        return {f.name: getattr(self, f.name)
                for f in dataclasses.fields(self)}

    @classmethod
    def from_dict(cls, d: Dict[str, Union[int, float]]) -> "OocStats":
        """Rebuild from :meth:`as_dict` output, each value in its field's
        type (the ``*_s`` timers stay floats); unknown keys are ignored."""
        kinds = {f.name: type(f.default) for f in dataclasses.fields(cls)}
        return cls(**{k: kinds[k](v) for k, v in d.items() if k in kinds})


def _run_key(driver: str, n: int, edges: np.ndarray, budget,
             partitioner, partitioner_seed: int, **extras) -> str:
    """Digest binding a journal to one run configuration: the driver, the
    canonical edge bytes and every parameter that changes the run's
    trajectory, so ``resume=True`` never continues a snapshot of another
    graph or configuration (a mesh run's ``devices`` among them, so a
    journal written on two ranks is not resumed on one).  The same digest
    as the JAX package's for the same arguments."""
    pname = (partitioner if isinstance(partitioner, str)
             else getattr(partitioner, "__name__", "custom"))
    h = hashlib.sha256()
    desc = "|".join(
        [driver, f"n={n}", f"budget={budget}", f"part={pname}",
         f"seed={partitioner_seed}"]
        + [f"{k}={v}" for k, v in sorted(extras.items())])
    h.update(desc.encode())
    h.update(np.ascontiguousarray(edges, dtype=np.int64).tobytes())
    return h.hexdigest()[:16]


def _parse_every(every: Union[int, str]) -> Tuple[str, float]:
    """Normalize a ``checkpoint_every`` knob to ``(mode, value)``: an int is
    an event count (``("events", k)``, floored at 1); a duration string —
    ``"30s"``, ``"500ms"``, ``"5m"``, ``"1h"`` — a wall-clock interval
    (``("time", seconds)``)."""
    if isinstance(every, str):
        match = re.fullmatch(r"\s*(\d+(?:\.\d+)?)\s*(ms|s|m|h)\s*", every)
        if match is None:
            raise ValueError(
                f"checkpoint_every={every!r}: expected an event count or a "
                f"duration like '30s', '500ms', '5m', '1h'")
        secs = float(match.group(1)) * {"ms": 1e-3, "s": 1.0, "m": 60.0,
                                        "h": 3600.0}[match.group(2)]
        if secs <= 0:
            raise ValueError(
                f"checkpoint_every={every!r}: duration must be positive")
        return "time", secs
    return "events", float(max(1, int(every)))


class RoundJournal:
    """Round-granular snapshot journal over ``checkpoint.manager``.

    One journal serves one run.  Each snapshot is a flat ``{name: array}``
    tree of host state plus metadata ``{stage, index, run_key, stats,
    **extra}``, written through the atomic tmp+rename save.  Steps continue
    across resumes (the constructor seeds the counter from the directory),
    and ``run_key`` is verified at load.  ``every`` gates writes by event
    count or wall clock (:func:`_parse_every`); ``clock`` injects the time
    source for tests.  With the run's graph ``store``, each snapshot first
    absorbs the store's counters into ``stats`` (a resumed run's counters
    then include the I/O before the crash), and its payload is held in the
    store's ``IoAccount`` while it is written, so checkpoint bytes and
    chunk bytes share one budget.  With a ``mesh`` the journal is the
    mesh's: rank 0 alone writes the snapshots, and every rank reads the
    newest one after a barrier.  Every rank counts each snapshot: a
    time-gated one is due when rank 0's clock says so (one MAX all-reduce
    a record; the ranks record in step, since they agree on every
    dispatch).
    """

    def __init__(self, ckpt_dir: str, run_key: str, *,
                 every: Union[int, str] = 1, keep: int = 3,
                 clock: Callable[[], float] = time.monotonic,
                 store: Optional[GraphStore] = None, mesh=None):
        self.ckpt_dir = ckpt_dir
        self.run_key = run_key
        self.group = None if mesh is None else dist_lib.mesh_group(mesh)
        self.writer = self.group is None or tdist.get_rank(self.group) == 0
        self.mode, self.every = _parse_every(every)
        self.keep = keep
        self.store = store
        self._clock = clock
        self._last_write = clock()
        self.seq = int(ckpt.latest_step(ckpt_dir) or 0)
        self._events = 0

    def _due(self) -> bool:
        if self.mode != "time":
            return self._events % int(self.every) == 0
        due = self._clock() - self._last_write >= self.every
        if self.group is None:
            return due
        return dist_lib.rank0_decides(due, self.group)

    def record(self, stage: str, index: int, arrays: Dict[str, np.ndarray],
               stats: OocStats, **extra) -> bool:
        """Journal one completed round or level when the ``every`` gate is
        due; returns whether a snapshot was written.  The write is
        synchronous, so a completed round is never lost to a crash."""
        self._events += 1
        if not self._due():
            return False
        self.seq += 1
        stats.checkpoints += 1
        if self.store is not None:
            self.store.absorb_into(stats)
        if self.writer:
            meta = {"stage": stage, "index": int(index),
                    "run_key": self.run_key, "stats": stats.as_dict(),
                    **extra}
            # phi / lb / sup fit in int32; the restore paths cast back
            arrays = {k: (np.asarray(v).astype(np.int32)
                          if np.asarray(v).dtype == np.int64
                          else np.asarray(v)) for k, v in arrays.items()}
            account = getattr(self.store, "io_account", None)
            with (account.hold(sum(int(a.nbytes) for a in arrays.values()),
                               "checkpoint")
                  if account is not None else contextlib.nullcontext()):
                ckpt.save(self.ckpt_dir, self.seq, arrays, metadata=meta,
                          keep=self.keep)
        if self.mode == "time":
            self._last_write = self._clock()
        return True

    def load_latest(self):
        """``(arrays, meta)`` of the newest intact snapshot, or None when
        there is none (empty, or every snapshot corrupt: the run starts
        fresh, with a warning).  A ``run_key`` mismatch raises."""
        if self.group is not None:
            dist_lib.barrier(self.group)
        try:
            tree, meta = ckpt.restore(self.ckpt_dir)
        except FileNotFoundError:
            return None
        except ckpt.CheckpointCorruptionError as e:
            warnings.warn(
                f"no intact snapshot under {self.ckpt_dir!r} ({e}); "
                f"starting the run from scratch", stacklevel=2)
            return None
        if meta.get("run_key") != self.run_key:
            raise ValueError(
                f"checkpoint_dir {self.ckpt_dir!r} holds a journal for a "
                f"different run (run_key {meta.get('run_key')!r} != "
                f"{self.run_key!r}); refusing to resume")
        return tree, meta


@dataclasses.dataclass
class LowerBoundResult:
    edges: np.ndarray        # canonical edge list of the original graph
    phi: np.ndarray          # trussness; filled with 2 for the exact Phi_2
    lb: np.ndarray           # lower bound phi(e) for G_new edges (>= 2)
    in_gnew: np.ndarray      # bool mask: edge still undecided (in G_new)
    stats: OocStats

    @property
    def rounds(self) -> int:
        """Partition rounds (the paper's O(m/M) iterations)."""
        return self.stats.rounds

    @property
    def scans(self) -> int:
        """NS extractions (the I/O-scan analogue)."""
        return self.stats.scans

    @property
    def max_part_edges(self) -> int:
        """Largest NS working set seen (the budget check)."""
        return self.stats.max_part_edges


def _partition_rounds(
    n: int, edges: np.ndarray, budget: int, part_fn, stats: OocStats, *,
    with_incidence: bool = True, lane_multiple: int = 1,
    start_ids: Optional[np.ndarray] = None,
    store: Optional[GraphStore] = None,
) -> Iterator[Tuple[int, plib.PartitionBatch, np.ndarray, int,
                    Optional[float]]]:
    """Producer side of the double-buffered round pipeline.

    Yields ``(round_idx, batch, cur_ids, cur_budget, zone_state)`` per
    partition round: ``cur_ids`` maps the batch's current-graph edge ids to
    original ids, ``cur_budget`` is the budget the round was built at (what
    a resumed run restarts from), and ``zone_state`` is the partitioner's
    state after this round's feedback (:func:`_zone_state`; the consumer
    journals one round late, when the producer has already observed the
    next batch).  The round's internal edges leave the working graph
    (``Graph.remove_edges``) before the yield.  A round with no internal
    edge doubles the budget and yields nothing.  The triangle list is
    enumerated once and filtered against the surviving edges in later
    rounds.

    With a ``store`` the working graph and the triangle list live in the
    store between rounds: the successor graph is spilled BEFORE the
    predecessor is released (its aliased chunk files must be registered
    before the release drops the predecessor's references), the triangle
    list is spilled after round 1 and then stream-filtered chunk by chunk
    into a new key each round (a writer must not replace the key it is
    reading), and the next round's arrays are prefetched before the yield.

    ``start_ids`` restarts from a working graph that is a subset of
    ``edges`` (resume and budget restarts); round numbering continues from
    ``stats.rounds``.  The ``"partitioner"`` fault site fires at the start
    of every round.  ``lane_multiple`` > 1 (a mesh's lane-axis size) packs
    every batch waste-aware over a shape ladder of the run's earlier bucket
    shapes (``partition.build_partition_batch``).
    """
    if start_ids is None:
        cur_ids = np.arange(len(edges), dtype=np.int64)
    else:
        cur_ids = np.asarray(start_ids, dtype=np.int64)
    g = glib.build_graph(n, edges[cur_ids], store=store)
    if store is not None:
        g.spill()
        g.prefetch()
    cur_budget = budget
    tris_cur = None      # full triangle list of g, g-local edge ids
    tris_key = None      # the store key of the spilled triangle list
    ladder: list = []    # (cap_e, cap_t, lanes) of the mesh batches so far
    observe = getattr(part_fn, "observe", None)
    while g.m:
        t0 = time.perf_counter()
        stats.rounds += 1
        faults.check(faults.PARTITIONER, stage=1, round=stats.rounds,
                     budget=cur_budget)
        parts = part_fn(g, cur_budget, stats.rounds)
        if not parts:
            break
        spilled_round = tris_cur is None and tris_key is not None
        if spilled_round:
            stats.tri_rescans_avoided += 1
            tris_in = sup_lib.iter_triangle_chunks(store, tris_key)
        elif tris_cur is None:
            tris_cur = np.asarray(list_triangles(g), np.int64).reshape(-1, 3)
            tris_in = tris_cur
        else:
            stats.tri_rescans_avoided += 1
            tris_in = tris_cur
        batch = plib.build_partition_batch(
            g, parts, tris=tris_in, with_incidence=with_incidence,
            lane_multiple=lane_multiple,
            shape_ladder=ladder if lane_multiple > 1 else None)
        if spilled_round:
            stats.tri_reload_peak_rows = max(stats.tri_reload_peak_rows,
                                             batch.tri_peak_rows)
        if lane_multiple > 1:
            for b in batch.buckets:
                if (b.cap_e, b.cap_t, b.n_lanes) not in ladder:
                    ladder.append((b.cap_e, b.cap_t, b.n_lanes))
        stats.absorb_batch(batch)
        if observe is not None:
            observe(batch)
        removed = np.zeros(g.m, dtype=bool)
        for bucket in batch.buckets:
            removed[bucket.edge_ids[bucket.internal]] = True
        if not removed.any():
            # the batch is discarded un-launched
            stats.batches -= len(batch.buckets)
            cur_budget *= 2
            stats.round_build_s += time.perf_counter() - t0
            continue
        ids_snapshot = cur_ids
        cur_ids = cur_ids[~removed]
        g_prev, g = g, g.remove_edges(removed)
        remap = np.cumsum(~removed) - 1          # old id -> compacted id
        if tris_cur is not None and len(tris_cur):
            tris_cur = remap[tris_cur[~removed[tris_cur].any(axis=1)]]
        if store is not None:
            g.spill()
            g_prev.release()
            if spilled_round:
                new_key = store.graph_key() + "/tris"
                with sup_lib.stream_spill_triangles(store, new_key) as w:
                    for chunk in sup_lib.iter_triangle_chunks(store,
                                                              tris_key):
                        stats.tri_reload_peak_rows = max(
                            stats.tri_reload_peak_rows, int(len(chunk)))
                        w.append(remap[chunk[~removed[chunk].any(axis=1)]])
                    spilled_rows = w.rows
                store.release(tris_key)
                tris_key = new_key
            else:
                if tris_key is None:
                    tris_key = store.graph_key() + "/tris"
                sup_lib.spill_triangles(store, tris_key, tris_cur)
                spilled_rows = len(tris_cur)
            stats.tri_spill_rows = max(stats.tri_spill_rows,
                                       int(spilled_rows))
            tris_cur = None
            g.prefetch()
            store.prefetch([tris_key])
        stats.round_build_s += time.perf_counter() - t0
        yield (stats.rounds, batch, ids_snapshot, cur_budget,
               _zone_state(part_fn))


def _retry_stage1_round(eng: _Engine, stats: OocStats, shape_cache,
                        round_idx: int, batch, ids, fold_bucket, exc,
                        cur_budget: int, max_retries: int) -> None:
    """Blocking retry ladder for a failed stage-1 round.

    A poisoned :class:`~repro_torch.core.peel.PendingPeel` cannot be
    finalized again, but the buckets' host arrays survive, so the round is
    re-dispatched from them.  The ladder, engaged only for retryable
    failures (:func:`faults.is_retryable`):

    1. lane-split retries — each bucket as ``split_bucket_lanes``
       sub-buckets (split 2, then 4, ... up to ``max_retries`` doublings);
       a sub-bucket whose lane count no longer divides the lane axis runs
       single-device;
    2. mesh drop — ``eng.mesh = None`` for the rest of the run;
    3. budget halving — raise :class:`_RestartRounds`, down to
       ``_MIN_ROUND_BUDGET``; below the floor the failure propagates.

    Folds re-applied by a retry are idempotent (``lb`` is a running max,
    the rest set constants).
    """
    split = 1
    while True:
        if not faults.is_retryable(exc):
            raise exc
        stats.retries += 1
        if split < (1 << max_retries):
            split *= 2
        elif eng.mesh is not None:
            eng.mesh = None
            stats.degraded += 1
        else:
            if cur_budget <= _MIN_ROUND_BUDGET:
                raise exc
            stats.degraded += 1
            raise _RestartRounds(max(cur_budget // 2, _MIN_ROUND_BUDGET))
        release_cached_blocks(exc)
        try:
            for bi, bucket in enumerate(batch.buckets):
                for si, sub in enumerate(
                        plib.split_bucket_lanes(bucket, split)):
                    mesh = (eng.mesh if eng.mesh is not None
                            and sub.n_lanes % eng.n_dev == 0 else None)
                    h = _dispatch(eng, mesh, lambda: peel_classes_batched(
                        sub.sup, sub.tris, sub.alive,
                        shape_cache=shape_cache, blocking=False, mesh=mesh,
                        mesh_axis=eng.mesh_axis, kernel=eng.kernel,
                        device=eng.device,
                        fault_ctx={"stage": 1, "round": round_idx,
                                   "bucket": bi, "sub": si, "retry": split}))
                    stats.compiles += int(h.new_compile)
                    stats.batches += 1
                    phi_b, _ = h.result()
                    fold_bucket(round_idx, sub, ids, phi_b)
            return
        except Exception as e:
            exc = e


def _perpart_guard(engine: str, *, mesh=None, checkpointing=False,
                   store=None) -> None:
    """The per-part engine takes no mesh, journal or store (the reference's
    errors); anything but the two engines raises."""
    if engine == "perpart":
        if mesh is not None:
            raise ValueError("mesh= requires the batched engine")
        if checkpointing:
            raise ValueError(
                "checkpointing requires the batched engine "
                "(engine='perpart' is the uninstrumented seed baseline)")
        if store is not None:
            raise ValueError(
                "store= requires the batched engine "
                "(engine='perpart' is the uninstrumented seed baseline)")
    elif engine != "batched":
        raise ValueError(f"unknown engine {engine!r}")


def _local_truss(sub_edges: np.ndarray, n: int, device) -> np.ndarray:
    """Trussness of every edge of a subgraph (the per-part seed peel): one
    ``build_graph`` over the full vertex space, one host listing and one
    in-memory peel (``peel.peel_classes``) a call."""
    g = glib.build_graph(n, sub_edges)
    if g.m == 0:
        return np.zeros(0, np.int64)
    tris = list_triangles(g)
    sup = support_from_triangle_list(tris, g.m).astype(np.int32)
    if len(tris) == 0:
        tris = np.full((1, 3), g.m, np.int32)  # points at the drop slot
    phi, _ = peel_classes(sup, tris, np.ones(g.m, bool), device=device)
    return phi.cpu().numpy().astype(np.int64)


def _perpart_rounds(n, edges, budget, part_fn, stats: OocStats):
    """The per-part seed's round loop, shared by its stage 1 and its
    ``partitioned_support``: every round rebuilds the working graph over
    the edges still in it and yields each non-empty part's NS as
    ``(cur_ids, sub_ids, sub_edges, internal)`` (``cur_ids`` maps the
    current graph's ids to the original ones).  The NS's internal edges
    leave the working graph when the round ends; a round that removes none
    doubles the budget.  Counts ``rounds`` and ``scans`` (one a part)."""
    alive = np.ones(len(edges), dtype=bool)     # still in the working graph
    cur_budget = budget
    while alive.any():
        stats.rounds += 1
        cur_ids = np.nonzero(alive)[0]
        g = glib.build_graph(n, edges[cur_ids])
        parts = part_fn(g, cur_budget, stats.rounds)
        if not parts:
            break
        round_removed = np.zeros(len(cur_ids), dtype=bool)
        for part in parts:
            stats.scans += 1
            sub_ids, sub_edges, internal = glib.neighborhood_subgraph(g, part)
            if len(sub_ids) == 0:
                continue
            yield cur_ids, sub_ids, sub_edges, internal
            round_removed[sub_ids[internal]] = True
        if not round_removed.any():
            cur_budget *= 2                         # stall: grow the parts
            continue
        alive[cur_ids[round_removed]] = False


def _lower_bounding_perpart(n, edges, budget, part_fn,
                            device) -> LowerBoundResult:
    """Stage 1 of the seed path: every round rebuilds the working graph,
    scans each part's NS and peels it on its own (:func:`_local_truss`)."""
    m = len(edges)
    phi = np.zeros(m, dtype=np.int64)
    lb = np.full(m, 2, dtype=np.int64)
    in_gnew = np.zeros(m, dtype=bool)
    stats = OocStats()
    for cur_ids, sub_ids, sub_edges, internal in _perpart_rounds(
            n, edges, budget, part_fn, stats):
        stats.max_part_edges = max(stats.max_part_edges, len(sub_ids))
        stats.real_edges += len(sub_ids)
        stats.padded_slots += len(sub_ids)
        phi_local = _local_truss(sub_edges, n, device)
        glob_ids = cur_ids[sub_ids[internal]]       # original ids
        lb[glob_ids] = np.maximum(lb[glob_ids], phi_local[internal])
        if stats.rounds == 1:
            is2 = phi_local[internal] == 2
            phi[glob_ids[is2]] = 2
            in_gnew[glob_ids[~is2]] = True
        else:
            in_gnew[glob_ids] = True
    stats.parts = stats.batches = stats.scans       # one part a batch a scan
    return LowerBoundResult(edges=edges, phi=phi, lb=lb, in_gnew=in_gnew,
                            stats=stats)


def lower_bounding(n: int, edges: np.ndarray, budget: int,
                   partitioner: str = "sequential", engine: str = "batched",
                   *, partitioner_seed: int = 0, kernel: str = "auto",
                   device=None, mesh=None, mesh_axis="data",
                   journal: Optional[RoundJournal] = None,
                   restored=None, max_retries: int = 2,
                   engine_state: Optional[_Engine] = None,
                   store: Optional[GraphStore] = None) -> LowerBoundResult:
    """Algorithm 3: per-edge lower bounds plus the exact round-1 Phi_2.

    ``journal`` snapshots the fold state after each completed round ("lb"),
    ``restored`` (an ``(arrays, meta)`` pair from
    :meth:`RoundJournal.load_latest`) resumes from one, zone state
    included, and ``max_retries`` bounds the lane-split retries of a failed
    dispatch before the budget halves (:func:`_retry_stage1_round`).
    ``store`` keeps the working graph in a graph store between rounds; its
    counters land in ``OocStats``.  ``mesh`` splits every bucket's lanes
    over ``mesh_axis`` (or a (lane, tri) pair of names); ``engine_state``
    shares one :class:`_Engine` with the caller, so a mesh drop here
    carries into stage 2.  ``engine="perpart"`` runs the per-part seed
    baseline instead (the same bounds; no journal, store or mesh).
    """
    check_kernel(kernel)
    part_fn = _resolve_partitioner(partitioner, seed=partitioner_seed)
    edges = glib.canonical_edges(edges, n)
    _perpart_guard(engine, mesh=mesh, store=store,
                   checkpointing=journal is not None or restored is not None)
    eng = engine_state if engine_state is not None else _Engine(
        kernel=kernel, device=resolve_device(device), mesh=mesh,
        mesh_axis=mesh_axis)
    if engine == "perpart":
        return _lower_bounding_perpart(n, edges, budget, part_fn, eng.device)
    m = len(edges)
    phi = np.zeros(m, dtype=np.int64)
    lb = np.full(m, 2, dtype=np.int64)
    in_gnew = np.zeros(m, dtype=bool)
    alive = np.ones(m, dtype=bool)        # still in the working graph
    stats = OocStats(devices=eng.devices)
    start_budget = budget
    if restored is not None:
        # the fold state is four flat arrays over original edge ids; the
        # working graph is edges[alive] (phi is exact under any partition
        # sequence)
        tree, meta = restored
        phi = tree["phi"].astype(np.int64)
        lb = tree["lb"].astype(np.int64)
        in_gnew = tree["in_gnew"].astype(bool)
        alive = tree["alive"].astype(bool)
        stats = OocStats.from_dict(meta["stats"])
        stats.resumed_round = int(meta["index"])
        stats.devices = eng.devices
        start_budget = int(meta.get("cur_budget", budget))
        _restore_zone_state(part_fn, meta.get("zone_state"))
    shape_cache: set = set()

    def fold_bucket(round_idx, bucket, ids, phi_b):
        """Fold one bucket's local trussness into lb/phi/in_gnew/alive;
        internal edges live in exactly one part, so the scatters never
        collide, and each is idempotent."""
        int_mask = bucket.internal
        glob = ids[bucket.edge_ids[int_mask]]
        phi_int = np.asarray(phi_b)[int_mask].astype(np.int64)
        np.maximum.at(lb, glob, phi_int)
        if round_idx == 1:
            # exact Phi_2: internal support == global support in round 1
            is2 = phi_int == 2
            phi[glob[is2]] = 2
            in_gnew[glob[~is2]] = True
        else:
            in_gnew[glob] = True
        alive[glob] = False

    def record(round_idx, cur_b, zs):
        if journal is not None:
            journal.record("lb", round_idx,
                           {"phi": phi, "lb": lb, "in_gnew": in_gnew,
                            "alive": alive},
                           stats, cur_budget=int(cur_b), zone_state=zs)

    def consume(pending):
        """Land one round's folds, retrying on failure, then journal it."""
        round_idx, batch, ids, handles, cur_b, zs = pending
        try:
            t0 = time.perf_counter()
            results = [h.result()[0] for h in handles]
            stats.peel_s += time.perf_counter() - t0
            for bucket, phi_b in zip(batch.buckets, results):
                fold_bucket(round_idx, bucket, ids, phi_b)
        except Exception as exc:
            _retry_stage1_round(eng, stats, shape_cache, round_idx, batch,
                                ids, fold_bucket, exc, cur_b, max_retries)
        record(round_idx, cur_b, zs)

    # Double-buffered rounds: dispatch round r, let the generator build
    # round r + 1, then consume r's results.  The outer loop is the budget
    # restart of the ladder: the generator is rebuilt from the fold state's
    # alive mask (an un-folded round's edges are all still alive).
    while True:
        start_ids = np.nonzero(alive)[0]
        if not len(start_ids):
            break
        pending = None
        try:
            for round_idx, batch, ids, cur_b, zs in _partition_rounds(
                    n, edges, start_budget, part_fn, stats,
                    lane_multiple=eng.n_dev, start_ids=start_ids,
                    store=store):
                t0 = time.perf_counter()
                try:
                    handles = []
                    for bi, bucket in enumerate(batch.buckets):
                        h = _dispatch(
                            eng, eng.mesh, lambda: peel_classes_batched(
                                bucket.sup, bucket.tris, bucket.alive,
                                shape_cache=shape_cache, blocking=False,
                                mesh=eng.mesh, mesh_axis=eng.mesh_axis,
                                kernel=eng.kernel, device=eng.device,
                                fault_ctx={"stage": 1, "round": round_idx,
                                           "bucket": bi, "retry": 0}))
                        stats.compiles += int(h.new_compile)
                        handles.append(h)
                    stats.sharded_rounds += int(
                        any(h.sharded for h in handles))
                except Exception as exc:
                    stats.peel_s += time.perf_counter() - t0
                    # the previous round's handles are fine: land its folds
                    # first, so a budget restart cannot lose it
                    if pending is not None:
                        consume(pending)
                        pending = None
                    _retry_stage1_round(eng, stats, shape_cache, round_idx,
                                        batch, ids, fold_bucket, exc,
                                        cur_b, max_retries)
                    record(round_idx, cur_b, zs)
                    continue
                stats.peel_s += time.perf_counter() - t0
                if pending is not None:
                    stats.overlapped += 1
                    consume(pending)
                pending = (round_idx, batch, ids, handles, cur_b, zs)
            if pending is not None:
                consume(pending)
            break
        except _RestartRounds as r:
            start_budget = r.budget
    if store is not None:
        store.absorb_into(stats)
    return LowerBoundResult(edges=edges, phi=phi, lb=lb, in_gnew=in_gnew,
                            stats=stats)


@dataclasses.dataclass
class BottomUpResult:
    edges: np.ndarray
    phi: np.ndarray
    kmax: int
    rounds: int
    scans: int
    candidate_sizes: List[int]   # |H| per k (I/O + working-set accounting)
    stats: OocStats


def _retry_candidate_peel(eng: _Engine, stats: OocStats, exc, dispatch,
                          max_retries: int = 2):
    """Blocking retry ladder for a failed stage-2 / top-down candidate
    peel.  The candidate's host arrays survive, so a retry re-dispatches
    the same level (``dispatch(retry)`` dispatches, blocks and returns the
    result).  After ``max_retries`` failures the mesh is dropped and the
    retries start over single-device; then the failure propagates."""
    attempt = 0
    while True:
        if not faults.is_retryable(exc):
            raise exc
        stats.retries += 1
        attempt += 1
        if attempt > max_retries:
            if eng.mesh is None:
                raise exc
            eng.mesh = None
            stats.degraded += 1
            attempt = 0
        release_cached_blocks(exc)
        try:
            return dispatch(attempt)
        except Exception as e:
            exc = e


def bottom_up_decompose(n: int, edges: np.ndarray, budget: int,
                        partitioner: str = "sequential",
                        engine: str = "batched", *,
                        partitioner_seed: int = 0, kernel: str = "auto",
                        device=None, mesh=None, mesh_axis="data",
                        checkpoint_dir=None,
                        checkpoint_every: Union[int, str] = 1,
                        resume: bool = False, checkpoint_keep: int = 3,
                        max_retries: int = 2,
                        store=None) -> BottomUpResult:
    """Algorithm 4: full decomposition under a working-set budget (NS edge
    entries per part).  ``device=None`` means the CUDA card.

    ``checkpoint_dir`` journals every ``checkpoint_every``-th completed
    stage-1 round ("lb" snapshots) and stage-2 level ("s2"), keeping the
    newest ``checkpoint_keep``; ``resume=True`` restores the newest intact
    snapshot of this configuration and continues, to the phi of an
    uninterrupted run.  ``max_retries`` bounds the lane-split retries of a
    failed dispatch.  ``OocStats.retries / degraded / checkpoints /
    resumed_round`` record all of it.  ``store`` (a ``core.store``
    graph store) keeps stage 1's working graph and triangle list in the
    store between rounds, with the store's counters in ``OocStats``; it
    changes no result and is not part of the journal's run key.

    ``mesh`` (every rank of it makes the same call) splits stage 1's bucket
    lanes over ``mesh_axis`` and triangle-shards each stage-2 level peel
    over it (a (lane, tri) pair: lanes over the first name, each lane's
    rows and each level's rows over both); ``OocStats.devices`` /
    ``sharded_rounds`` record the routing, and a ladder's mesh drop
    finishes the run single-device.  The journal's run key binds the
    device count.

    ``engine="perpart"`` is the per-part seed baseline: stage 1 by
    :func:`_lower_bounding_perpart`, and every stage-2 level built over the
    full vertex space, listed and peeled by ``peel.peel_threshold`` with
    no pre-building; the same phi, rounds and scans as the reference's, no
    journal or store; ``mesh`` raises ``ValueError`` with it.
    """
    _perpart_guard(engine, mesh=mesh, store=store,
                   checkpointing=checkpoint_dir is not None)
    check_kernel(kernel)
    dev = resolve_device(device)
    edges = glib.canonical_edges(edges, n)
    journal = snap = None
    if checkpoint_dir is not None:
        key = _run_key("bottom_up", n, edges, budget, partitioner,
                       partitioner_seed,
                       devices=dist_lib.mesh_devices(mesh, mesh_axis))
        journal = RoundJournal(checkpoint_dir, key, every=checkpoint_every,
                               keep=checkpoint_keep, store=store, mesh=mesh)
        if resume:
            snap = journal.load_latest()

    eng = _Engine(kernel=kernel, device=dev, mesh=mesh, mesh_axis=mesh_axis)
    if snap is not None and snap[1]["stage"] == "s2":
        # stage 1 is complete in the snapshot: rebuild the stage-2 state
        tree, meta = snap
        phi = tree["phi"].astype(np.int64)
        lb = tree["lb"].astype(np.int64)
        remaining = tree["remaining"].astype(bool)
        stats = OocStats.from_dict(meta["stats"])
        stats.resumed_round = int(meta["index"])
        stats.devices = eng.devices
        k0 = int(meta["index"]) + 1     # the journaled level is complete
    else:
        lbres = lower_bounding(
            n, edges, budget, partitioner, engine,
            partitioner_seed=partitioner_seed,
            journal=journal, max_retries=max_retries, engine_state=eng,
            restored=snap if snap is not None
            and snap[1]["stage"] == "lb" else None, store=store)
        phi = lbres.phi.copy()
        lb = lbres.lb
        remaining = lbres.in_gnew.copy()
        stats = lbres.stats
        k0 = 2
    cand_sizes: List[int] = []
    shape_cache: set = set()

    def candidate_masks(k_b: int):
        """H = NS(U_k) within the remaining edges, U_k the endpoints of the
        remaining edges with lb <= k_b: ``(h_ids, internal)``, or None
        when no remaining edge admits class k_b."""
        elig = remaining & (lb <= k_b)
        if not elig.any():
            return None
        u_k = np.zeros(n, dtype=bool)
        eg = edges[elig]
        u_k[eg[:, 0]] = True
        u_k[eg[:, 1]] = True
        u_in = u_k[edges[:, 0]]
        v_in = u_k[edges[:, 1]]
        return (np.nonzero(remaining & (u_in | v_in))[0],
                remaining & u_in & v_in)

    def build_candidate(k_b: int):
        """Host half of one stage-2 level: the candidate of
        :func:`candidate_masks`, compacted and triangle-listed; None when
        no remaining edge admits class k_b.  Built one level ahead, its U
        is a superset of the true U_{k+1}, which is sound (see the
        reference)."""
        t0 = time.perf_counter()
        try:
            masks = candidate_masks(k_b)
            if masks is None:
                return None
            h_ids, internal = masks
            local_edges, verts = glib.compact_edge_list(edges[h_ids])
            sub = glib.build_graph(len(verts), local_edges)
            tris = np.asarray(list_triangles(sub), np.int32).reshape(-1, 3)
            return k_b, h_ids, tris, internal
        finally:
            stats.candidate_build_s += time.perf_counter() - t0

    def peel_level(k_b, sup, tris, removable, alive_h, retry):
        """Dispatch one level's peel (non-blocking)."""
        h = _dispatch(eng, eng.mesh, lambda: local_threshold_peel(
            sup, tris, removable, k_b - 2, alive0=alive_h,
            shape_cache=shape_cache, blocking=False, mesh=eng.mesh,
            mesh_axis=eng.mesh_axis, kernel=eng.kernel, device=eng.device,
            fault_ctx={"stage": 2, "k": int(k_b), "retry": retry}))
        stats.compiles += int(h.new_compile)
        stats.batches += 1
        return h

    k = k0
    pre = None          # candidate pre-built while the previous level peeled
    while remaining.any():
        # skip empty classes: jump k straight to the smallest lower bound
        k = max(k, int(lb[remaining].min()))
        stats.scans += 1
        if engine == "perpart":
            # the seed path: a blocking level over the full vertex space
            # (not empty, by the k-jump above)
            h_ids, internal = candidate_masks(k)
            cand_sizes.append(len(h_ids))
            sub = glib.build_graph(n, edges[h_ids])
            tris = list_triangles(sub)
            sup = support_from_triangle_list(tris, sub.m).astype(np.int32)
            if len(tris) == 0:
                tris = np.full((1, 3), sub.m, np.int32)
            _, _, removed = peel_threshold(sup, tris, np.ones(sub.m, bool),
                                           internal[h_ids], k - 2,
                                           device=dev)
            rm_glob = h_ids[host_array(removed)]
            phi[rm_glob] = k
            remaining[rm_glob] = False
            k += 1
            continue
        if pre is not None and pre[0] == k:
            cand = pre
            stats.stage2_overlapped += 1
        else:
            cand = build_candidate(k)
        _, h_ids, tris, internal = cand
        cand_sizes.append(len(h_ids))
        # kill the edges the previous level removed after this candidate was
        # built; supports count fully-alive triangles
        alive_h = remaining[h_ids]
        if len(tris):
            t_alive = (alive_h[tris[:, 0]] & alive_h[tris[:, 1]]
                       & alive_h[tris[:, 2]])
            sup = support_from_triangle_list(
                tris[t_alive], len(h_ids)).astype(np.int32)
        else:
            sup = np.zeros(len(h_ids), np.int32)
        removable = internal[h_ids]
        handle = dispatch_exc = None
        t0 = time.perf_counter()
        try:
            handle = peel_level(k, sup, tris, removable, alive_h, 0)
            stats.sharded_rounds += int(handle.sharded)
        except Exception as exc:
            dispatch_exc = exc          # enters the retry ladder below
        stats.peel_s += time.perf_counter() - t0
        pre = build_candidate(k + 1)
        t0 = time.perf_counter()
        try:
            if dispatch_exc is not None:
                raise dispatch_exc
            _, removed = handle.result()
        except Exception as exc:
            removed = _retry_candidate_peel(
                eng, stats, exc, lambda retry: peel_level(
                    k, sup, tris, removable, alive_h, retry).result()[1],
                max_retries)
        stats.peel_s += time.perf_counter() - t0
        rm_glob = h_ids[removed]
        phi[rm_glob] = k
        remaining[rm_glob] = False
        if journal is not None:
            journal.record("s2", k,
                           {"phi": phi, "lb": lb, "remaining": remaining},
                           stats)
        k += 1

    kmax = int(phi.max()) if len(phi) else 2
    if store is not None:
        store.absorb_into(stats)
    return BottomUpResult(edges=edges, phi=phi, kmax=kmax,
                          rounds=stats.rounds, scans=stats.scans,
                          candidate_sizes=cand_sizes, stats=stats)


# ---------------------------------------------------------------------------
# partitioned_support: exact supports under a budget (budgeted top-down)
# ---------------------------------------------------------------------------

def _support_credit_triples(bucket, round_idx: int, bi: int, sub_idx: int,
                            retry: int, *,
                            chunk_rows: int = 1 << 16) -> np.ndarray:
    """Flat parent-edge-id triples of one bucket's captured triangles — the
    compute half of a ``partitioned_support`` round, with no scatter into
    the global ``sup``: the credits are not idempotent, so a failed bucket
    is recomputed whole and folded once.  The ``"support"`` fault site
    fires here, before any credit exists.  The lane-wise gather walks
    ``bucket.tris`` in slabs of ``chunk_rows`` rows."""
    faults.check(faults.SUPPORT, stage=1, round=round_idx, bucket=bi,
                 sub=sub_idx, retry=retry)
    B = bucket.n_lanes
    # local ids -> parent edge ids, lane-wise; the drop slot cap_e maps to
    # -1, so padding rows vanish with the mask
    eid_pad = np.concatenate(
        [bucket.edge_ids, np.full((B, 1), -1, np.int64)], axis=1)
    lane = np.arange(B)[:, None, None]
    step = max(1, int(chunk_rows))
    out: List[np.ndarray] = []
    for lo in range(0, bucket.tris.shape[1], step):
        parent = eid_pad[lane, bucket.tris[:, lo:lo + step]]
        out.append(parent[parent[:, :, 0] >= 0].reshape(-1))
    return np.concatenate(out) if out else np.zeros(0, np.int64)


def _retry_support_round(eng: _Engine, stats: OocStats, round_idx: int,
                         batch, exc, cur_budget: int,
                         max_retries: int) -> List[np.ndarray]:
    """Retry ladder of a failed triangle-credit round, the sibling of
    :func:`_retry_stage1_round`: lane splits (every triangle lives in one
    lane of one bucket, so the sub-buckets' triples are exactly the
    batch's), the mesh drop (the credits are host work; the dropped mesh
    is the shared engine state's), then a budget-halving restart (the
    un-credited round's internal edges are all still alive).
    Returns the (sub-)buckets' triples; the caller folds them once."""
    split = 1
    while True:
        if not faults.is_retryable(exc):
            raise exc
        stats.retries += 1
        if split < (1 << max_retries):
            split *= 2
        elif eng.mesh is not None:
            eng.mesh = None
            stats.degraded += 1
        else:
            if cur_budget <= _MIN_ROUND_BUDGET:
                raise exc
            stats.degraded += 1
            raise _RestartRounds(max(cur_budget // 2, _MIN_ROUND_BUDGET))
        try:
            return _agreed(eng, lambda: [
                _support_credit_triples(sub, round_idx, bi, si, split)
                for bi, bucket in enumerate(batch.buckets)
                for si, sub in enumerate(
                    plib.split_bucket_lanes(bucket, split))])
        except Exception as e:
            exc = e


def partitioned_support(n: int, edges: np.ndarray, budget: int,
                        partitioner: str = "sequential",
                        engine: str = "batched", with_stats: bool = False,
                        *, partitioner_seed: int = 0, mesh=None,
                        mesh_axis="data",
                        journal: Optional[RoundJournal] = None,
                        restored=None, max_retries: int = 2, store=None):
    """Exact sup(e) w.r.t. the whole graph, under a working-set budget (the
    triangle-credit variant of Algorithm 3 that top-down's stage 1 uses).

    Invariant: every triangle is credited exactly once — in the first round
    in which one of its edges becomes internal (its internal edges lie in
    one part, and it loses an edge from the working graph the moment it is
    credited).  So the credits sum to 3T.

    All the work is host numpy: no peel runs, so the batches are built
    without supports or incidence and no device is taken.  ``journal`` /
    ``restored`` snapshot and resume the credit state after each completed
    round ("sup" snapshots).  A failed round (the ``"support"`` fault site)
    walks :func:`_retry_support_round`; a round's triples all exist before
    any is folded.  ``store`` keeps the working graph in a graph store
    between rounds.  A ``mesh`` records ``OocStats.devices`` (the credits
    never span it) and arms the ladder's mesh-drop rung, as in the
    reference; its ranks agree on each round's outcome.

    ``engine="perpart"`` is the per-part seed baseline: every round
    rebuilds the working graph and lists each part's NS on its own over
    the full vertex space (the same sup, rounds and scans; no journal or
    store, and ``restored`` raises).  ``mesh`` raises ``ValueError`` with
    it.
    """
    part_fn = _resolve_partitioner(partitioner, seed=partitioner_seed)
    edges = glib.canonical_edges(edges, n)
    # as in the reference, a journal without a snapshot to restore is
    # ignored by the per-part engine
    _perpart_guard(engine, mesh=mesh, store=store,
                   checkpointing=restored is not None)
    m = len(edges)
    sup = np.zeros(m, dtype=np.int64)
    alive = np.ones(m, dtype=bool)
    stats = OocStats(devices=dist_lib.mesh_devices(mesh, mesh_axis))
    cur_budget = budget
    if engine == "perpart":
        for cur_ids, sub_ids, sub_edges, _ in _perpart_rounds(
                n, edges, cur_budget, part_fn, stats):
            tris = list_triangles(glib.build_graph(n, sub_edges))
            if len(tris):
                # subgraph id -> current-graph id -> original id
                np.add.at(sup, cur_ids[sub_ids][tris.reshape(-1)], 1)
        return (sup, stats) if with_stats else sup
    if restored is not None:
        tree, meta = restored
        sup = tree["sup"].astype(np.int64)
        alive = tree["alive"].astype(bool)
        stats = OocStats.from_dict(meta["stats"])
        stats.resumed_round = int(meta["index"])
        stats.devices = dist_lib.mesh_devices(mesh, mesh_axis)
        cur_budget = int(meta.get("cur_budget", budget))
        _restore_zone_state(part_fn, meta.get("zone_state"))

    eng = _Engine(mesh=mesh, mesh_axis=mesh_axis)
    while True:
        start_ids = np.nonzero(alive)[0]
        if not len(start_ids):
            break
        try:
            for round_idx, batch, ids, cur_b, zs in _partition_rounds(
                    n, edges, cur_budget, part_fn, stats,
                    with_incidence=False, start_ids=start_ids, store=store):
                try:
                    trips = _agreed(eng, lambda: [
                        _support_credit_triples(bucket, round_idx, bi, 0, 0)
                        for bi, bucket in enumerate(batch.buckets)])
                except Exception as exc:
                    trips = _retry_support_round(eng, stats, round_idx,
                                                 batch, exc, cur_b,
                                                 max_retries)
                # fold only after every bucket's triples exist
                for trip in trips:
                    np.add.at(sup, ids[trip], 1)
                for bucket in batch.buckets:
                    alive[ids[bucket.edge_ids[bucket.internal]]] = False
                if journal is not None:
                    journal.record("sup", round_idx,
                                   {"sup": sup, "alive": alive}, stats,
                                   cur_budget=int(cur_b), zone_state=zs)
            break
        except _RestartRounds as r:
            cur_budget = r.budget
    if store is not None:
        store.absorb_into(stats)
    return (sup, stats) if with_stats else sup
