"""Chunked graph storage behind the :class:`~repro_torch.core.graph.Graph`
arrays (the port of ``repro.core.store``).

A :class:`GraphStore` maps flat keys (``"g3/edges"``, ``"g7/tris"``) to
host arrays, and a store-backed ``Graph`` routes every array attribute
through it, so the out-of-core drivers can keep the working graph and its
triangle list off the host between partition rounds.  Two stores:

* :class:`InMemoryStore` — a dict; ``get`` returns the registered array
  itself, so a run through it costs what a run without a store costs, and
  every counter stays 0;
* :class:`ChunkedDiskStore` — arrays cut into row chunks of ``chunk_bytes``
  and written to a directory; one background thread reads chunks ahead of
  the consumer, and ``host_memory_budget`` (bytes) caps what the store
  holds at once.  Chunk files are immutable and refcounted, so
  :meth:`~ChunkedDiskStore.put_filtered` (the spill side of
  ``Graph.remove_edges``) rewrites only the chunks that lost rows and
  aliases the others, :meth:`~ChunkedDiskStore.put_inserted` (the spill
  side of ``Graph.add_edges``) rewrites only the chunks a new row falls
  inside, and a reused ``rank`` costs no write at all.  Every
  chunk is committed by ``checkpoint.manager.atomic_file_write`` (tmp +
  rename) behind the ``"chunk-write"`` fault site, and read behind
  ``"chunk-read"``.

The budget bounds the bytes the store retains (chunks read ahead or
cached, shared with checkpoint writes through one :class:`IoAccount`); a
consumer that materializes an array holds its own copy.  Chunks are read
once: a consumed chunk leaves the cache, so what stays resident is the
read-ahead window, not the graph.

Counters (``StoreStats``, folded into ``OocStats``): a chunk request served
by a load scheduled earlier (finished or still running) is a
``prefetch_hit``, one that reads synchronously a ``prefetch_miss``;
``bytes_spilled`` counts the bytes written, so aliased chunks are free.
The prefetch thread reads files and builds numpy arrays only: it never
touches torch or the card.
"""

from __future__ import annotations

import concurrent.futures
import contextlib
import dataclasses
import os
import threading
import uuid
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np

from repro_torch.checkpoint import manager as _ckpt
from repro_torch.core import faults

# counters a store folds into an OocStats (names shared with bottom_up)
_ABSORB_KEYS = ("chunk_reads", "chunk_writes", "bytes_spilled",
                "prefetch_hits", "prefetch_misses")


class StoreError(RuntimeError):
    """A graph-store invariant violation (unknown key, torn chunk, size
    mismatch between a filter mask and its source manifest)."""


@dataclasses.dataclass
class StoreStats:
    """I/O counters of one store (absorbed into ``OocStats`` per run)."""

    chunk_reads: int = 0          # chunk payloads read back from disk
    chunk_writes: int = 0         # chunk payloads written (spilled)
    bytes_spilled: int = 0        # bytes written; aliased chunks cost 0
    prefetch_hits: int = 0        # requests served by a scheduled load
    prefetch_misses: int = 0      # requests that read synchronously
    peak_resident_bytes: int = 0  # high-water mark of retained chunk bytes

    @property
    def prefetch_hit_rate(self) -> float:
        total = self.prefetch_hits + self.prefetch_misses
        return self.prefetch_hits / total if total else 1.0

    def as_dict(self) -> Dict[str, int]:
        return {f.name: int(getattr(self, f.name))
                for f in dataclasses.fields(self)}


@dataclasses.dataclass
class IoAccount:
    """One budget account shared by graph-chunk I/O and checkpoint I/O.

    ``budget_bytes`` caps concurrently *reserved* host bytes: the chunked
    store reserves a chunk's bytes while it is scheduled/retained, and the
    round journal reserves a snapshot's payload while it serializes — so a
    checkpoint in flight transparently throttles chunk prefetch instead of
    stacking on top of it.  ``None`` means unaccounted (no cap).
    Reservations made with :meth:`hold` may overshoot the budget (a
    checkpoint must always be writable); only the store's *admission*
    check (:meth:`fits`) hard-gates.
    """

    budget_bytes: Optional[int] = None
    reserved: int = 0
    peak: int = 0
    chunk_bytes_total: int = 0        # cumulative chunk reservations
    checkpoint_bytes_total: int = 0   # cumulative checkpoint reservations
    _lock: threading.Lock = dataclasses.field(
        default_factory=threading.Lock, repr=False)

    def fits(self, nbytes: int) -> bool:
        if self.budget_bytes is None:
            return True
        with self._lock:
            return self.reserved + nbytes <= self.budget_bytes

    def reserve(self, nbytes: int, kind: str = "chunk") -> None:
        with self._lock:
            self.reserved += nbytes
            self.peak = max(self.peak, self.reserved)
            if kind == "checkpoint":
                self.checkpoint_bytes_total += nbytes
            else:
                self.chunk_bytes_total += nbytes

    def release(self, nbytes: int) -> None:
        with self._lock:
            self.reserved = max(0, self.reserved - nbytes)

    @contextlib.contextmanager
    def hold(self, nbytes: int, kind: str = "checkpoint"):
        """Reserve for the duration of a block (the journal's write path)."""
        self.reserve(nbytes, kind)
        try:
            yield
        finally:
            self.release(nbytes)


class GraphStore:
    """Key -> array mapping the packed ``Graph`` spills to and reads from.

    Keys are flat strings namespaced by :meth:`graph_key`
    (``"g<N>/<array>"``); :meth:`release` drops a whole namespace.  The
    base class provides the counter plumbing and degenerate defaults
    (``put_filtered`` / ``alias`` fall back to a plain ``put``) so a
    subclass only has to implement ``put`` / ``get`` / ``release``.
    """

    def __init__(self):
        self.stats = StoreStats()
        self.io_account: Optional[IoAccount] = None
        self._graph_seq = 0
        self._absorbed: Dict[str, int] = {}

    # -- required interface -------------------------------------------------
    def put(self, key: str, arr: np.ndarray) -> None:
        raise NotImplementedError

    def get(self, key: str) -> np.ndarray:
        raise NotImplementedError

    def release(self, key: str) -> None:
        """Drop ``key`` and every key under ``key + "/"``."""
        raise NotImplementedError

    # -- optional hooks ------------------------------------------------------
    def prefetch(self, keys: Sequence[str]) -> None:
        """Hint that ``keys`` will be read soon (no-op by default)."""

    def put_filtered(self, dst: str, src: str, keep: np.ndarray,
                     arr: np.ndarray) -> None:
        """Register ``arr == get(src)[keep]`` under ``dst``; a chunked
        store reuses source chunks whose rows are all kept."""
        self.put(dst, arr)

    def alias(self, dst: str, src: str, arr: np.ndarray) -> None:
        """Register ``arr == get(src)`` under ``dst`` without a rewrite
        when the backend supports it (``rank`` reuse across rounds)."""
        self.put(dst, arr)

    def put_inserted(self, dst: str, src: str, is_new: np.ndarray,
                     arr: np.ndarray) -> None:
        """Register ``arr`` under ``dst`` where ``arr[~is_new] == get(src)``
        (the spill of a ``Graph.add_edges`` successor); a chunked store
        aliases the source chunks that no insertion point falls inside."""
        self.put(dst, arr)

    def get_chunks(self, key: str):
        """Yield ``get(key)`` piecewise so a consumer can bound its peak
        working set to one chunk; the base store yields the whole array."""
        arr = self.get(key)
        if len(arr):
            yield arr

    def stream_put(self, key: str, dtype, trail: Tuple[int, ...] = ()):
        """An appendable writer registering ``key`` at ``close()``; the
        base store buffers and concatenates, a chunked store flushes
        incrementally at chunk granularity (so a streaming producer never
        holds the full array)."""
        return _BufferedStreamWriter(self, key, dtype, trail)

    def close(self) -> None:
        """Release backend resources (threads, files)."""

    # -- shared plumbing -----------------------------------------------------
    def graph_key(self) -> str:
        """A fresh ``"g<N>"`` namespace for one working graph."""
        self._graph_seq += 1
        return f"g{self._graph_seq}"

    def absorb_into(self, ooc_stats) -> None:
        """Fold the counter DELTA since the last absorb into an
        ``OocStats`` — callable repeatedly (journal snapshots mid-run, the
        driver once more at the end) without double counting."""
        for name in _ABSORB_KEYS:
            cur = int(getattr(self.stats, name))
            prev = self._absorbed.get(name, 0)
            if hasattr(ooc_stats, name):
                setattr(ooc_stats, name,
                        getattr(ooc_stats, name) + (cur - prev))
            self._absorbed[name] = cur

    def __enter__(self) -> "GraphStore":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


class InMemoryStore(GraphStore):
    """Current behavior: arrays stay host-resident, ``get`` is zero-copy.

    Exists so the store interface can be driven through the whole matrix
    (store × engine × partitioner) with no behavioral delta against the
    storeless path; every counter stays 0.
    """

    def __init__(self):
        super().__init__()
        self._data: Dict[str, np.ndarray] = {}

    def put(self, key: str, arr: np.ndarray) -> None:
        self._data[key] = np.asarray(arr)

    def get(self, key: str) -> np.ndarray:
        try:
            return self._data[key]
        except KeyError:
            raise StoreError(f"unknown store key {key!r}") from None

    def release(self, key: str) -> None:
        prefix = key + "/"
        for k in [k for k in self._data
                  if k == key or k.startswith(prefix)]:
            del self._data[k]


class _BufferedStreamWriter:
    """Base-store ``stream_put`` writer: buffer chunks, ``put`` on close."""

    def __init__(self, store: GraphStore, key: str, dtype,
                 trail: Tuple[int, ...]):
        self._store = store
        self._key = key
        self._dtype = np.dtype(dtype)
        self._trail = tuple(int(d) for d in trail)
        self._parts: List[np.ndarray] = []
        self._closed = False

    @property
    def rows(self) -> int:
        return sum(len(p) for p in self._parts)

    def append(self, arr: np.ndarray) -> None:
        part = np.asarray(arr, self._dtype).reshape((-1,) + self._trail)
        if len(part):
            self._parts.append(part)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._parts:
            arr = (self._parts[0] if len(self._parts) == 1
                   else np.concatenate(self._parts))
        else:
            arr = np.empty((0,) + self._trail, dtype=self._dtype)
        self._parts = []
        self._store.put(self._key, arr)

    def __enter__(self) -> "_BufferedStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()


@dataclasses.dataclass
class _Chunk:
    """One immutable row-range of a stored array, on disk."""

    path: str
    key: str                 # owning store key (fault-injection context)
    index: int               # chunk position within the key
    rows: int
    nbytes: int


@dataclasses.dataclass
class _Manifest:
    dtype: str
    trail: Tuple[int, ...]   # trailing dims (rows, *trail)
    rows: int
    chunks: List[_Chunk]


# worker marker for a load skipped at execution time (budget full)
_SKIPPED = object()


class ChunkedDiskStore(GraphStore):
    """Edge/CSR/triangle chunks spilled to ``directory`` under a host
    residency budget, with background prefetch.

    ``host_memory_budget`` (bytes) caps concurrently retained chunk bytes
    through the shared :class:`IoAccount`; ``None`` removes the cap.
    ``chunk_bytes`` sizes the row chunks, ``lookahead`` is how many chunks
    the streaming reader schedules ahead of the one it is copying out.

    The directory is a scratch cache owned by this store: manifests live
    in memory, so ``__init__`` sweeps spill files (``*.bin`` / ``*.tmp``)
    left behind by a previous — possibly SIGKILLed — process.  Crash
    durability belongs to the checkpoint journal, not the store; a resumed
    run re-spills its working graph from the journaled host state.
    """

    def __init__(self, directory: str,
                 host_memory_budget: Optional[int] = None, *,
                 chunk_bytes: int = 1 << 20, lookahead: int = 4,
                 io_account: Optional[IoAccount] = None):
        super().__init__()
        if host_memory_budget is not None and host_memory_budget <= 0:
            raise ValueError(
                f"host_memory_budget must be a positive byte count, got "
                f"{host_memory_budget!r}")
        if chunk_bytes <= 0:
            raise ValueError(
                f"chunk_bytes must be a positive byte count, got "
                f"{chunk_bytes!r}")
        if lookahead <= 0:
            raise ValueError(
                f"lookahead must be a positive chunk count, got "
                f"{lookahead!r}")
        self.directory = directory
        self.chunk_bytes = int(chunk_bytes)
        self.lookahead = int(lookahead)
        self.io_account = (io_account if io_account is not None
                           else IoAccount(budget_bytes=host_memory_budget))
        os.makedirs(directory, exist_ok=True)
        for name in os.listdir(directory):
            if name.endswith(".bin") or name.endswith(".tmp"):
                with contextlib.suppress(OSError):
                    os.remove(os.path.join(directory, name))
        self._nonce = uuid.uuid4().hex[:8]
        self._file_seq = 0
        self._lock = threading.Lock()
        self._manifests: Dict[str, _Manifest] = {}
        self._file_refs: Dict[str, int] = {}
        self._futures: Dict[str, concurrent.futures.Future] = {}
        self._resident = 0       # bytes reserved for scheduled/retained chunks
        self._pool = concurrent.futures.ThreadPoolExecutor(
            max_workers=1, thread_name_prefix="graphstore-prefetch")

    # -- chunk I/O primitives (the registered fault sites) -------------------
    def _write_chunk(self, path: str, payload: bytes, *, key: str,
                     index: int) -> None:
        """Commit one chunk via the checkpoint writer's tmp+rename path."""
        faults.check(faults.CHUNK_WRITE, key=key, chunk=index, path=path)
        _ckpt.atomic_file_write(path, payload)
        with self._lock:
            self.stats.chunk_writes += 1
            self.stats.bytes_spilled += len(payload)

    def _read_chunk(self, chunk: _Chunk) -> bytes:
        faults.check(faults.CHUNK_READ, key=chunk.key, chunk=chunk.index,
                     path=chunk.path)
        try:
            with open(chunk.path, "rb") as f:
                data = f.read()
        except OSError as e:
            raise StoreError(
                f"chunk {chunk.index} of {chunk.key!r} unreadable "
                f"({e})") from e
        if len(data) != chunk.nbytes:
            raise StoreError(
                f"chunk {chunk.index} of {chunk.key!r} is torn: expected "
                f"{chunk.nbytes} bytes, found {len(data)}")
        with self._lock:
            self.stats.chunk_reads += 1
        return data

    # -- write side ----------------------------------------------------------
    def _next_path(self) -> str:
        self._file_seq += 1
        return os.path.join(self.directory,
                            f"{self._nonce}-{self._file_seq:08d}.bin")

    def put(self, key: str, arr: np.ndarray) -> None:
        arr = np.ascontiguousarray(arr)
        self.release(key)
        trail = tuple(int(d) for d in arr.shape[1:])
        row_bytes = int(arr.itemsize * int(np.prod(trail, dtype=np.int64)))
        rows_per = max(1, self.chunk_bytes // max(row_bytes, 1))
        chunks: List[_Chunk] = []
        for i, start in enumerate(range(0, len(arr), rows_per)):
            part = arr[start:start + rows_per]
            payload = part.tobytes()
            with self._lock:
                path = self._next_path()
            self._write_chunk(path, payload, key=key, index=i)
            chunks.append(_Chunk(path=path, key=key, index=i,
                                 rows=len(part), nbytes=len(payload)))
        with self._lock:
            for c in chunks:
                self._file_refs[c.path] = 1
            self._manifests[key] = _Manifest(
                dtype=str(arr.dtype), trail=trail, rows=len(arr),
                chunks=chunks)

    def put_filtered(self, dst: str, src: str, keep: np.ndarray,
                     arr: np.ndarray) -> None:
        """Chunk-wise filter: ``arr == get(src)[keep]``, but chunks whose
        rows are all kept become manifest aliases of the source files —
        zero write I/O for untouched row ranges."""
        with self._lock:
            src_man = self._manifests.get(src)
        keep = np.asarray(keep, dtype=bool)
        if src_man is None or len(keep) != src_man.rows:
            self.put(dst, arr)
            return
        arr = np.ascontiguousarray(arr)
        kept_prefix = np.concatenate(
            [np.zeros(1, np.int64), np.cumsum(keep, dtype=np.int64)])
        if int(kept_prefix[-1]) != len(arr):
            raise StoreError(
                f"put_filtered({dst!r}): mask keeps {int(kept_prefix[-1])} "
                f"rows of {src!r} but the filtered array has {len(arr)}")
        self.release(dst)
        chunks: List[_Chunk] = []
        new_refs: List[str] = []
        off_old = 0
        off_new = 0
        idx = 0
        for c in src_man.chunks:
            kept = int(kept_prefix[off_old + c.rows] - kept_prefix[off_old])
            if kept == c.rows:
                chunks.append(_Chunk(path=c.path, key=dst, index=idx,
                                     rows=c.rows, nbytes=c.nbytes))
                new_refs.append(c.path)
                idx += 1
            elif kept > 0:
                part = arr[off_new:off_new + kept]
                payload = part.tobytes()
                with self._lock:
                    path = self._next_path()
                self._write_chunk(path, payload, key=dst, index=idx)
                chunks.append(_Chunk(path=path, key=dst, index=idx,
                                     rows=kept, nbytes=len(payload)))
                idx += 1
            off_old += c.rows
            off_new += kept
        with self._lock:
            for path in new_refs:
                self._file_refs[path] = self._file_refs.get(path, 0) + 1
            for c in chunks:
                self._file_refs.setdefault(c.path, 1)
            self._manifests[dst] = _Manifest(
                dtype=str(arr.dtype), trail=src_man.trail, rows=len(arr),
                chunks=chunks)

    def alias(self, dst: str, src: str, arr: np.ndarray) -> None:
        """Register ``dst`` as a zero-I/O view of ``src``'s chunks (the
        reused ``rank`` across ``remove_edges`` rounds)."""
        with self._lock:
            src_man = self._manifests.get(src)
        if src_man is None:
            self.put(dst, arr)
            return
        self.release(dst)
        with self._lock:
            chunks = [_Chunk(path=c.path, key=dst, index=i, rows=c.rows,
                             nbytes=c.nbytes)
                      for i, c in enumerate(src_man.chunks)]
            for c in chunks:
                self._file_refs[c.path] = self._file_refs.get(c.path, 0) + 1
            self._manifests[dst] = _Manifest(
                dtype=src_man.dtype, trail=src_man.trail, rows=src_man.rows,
                chunks=chunks)

    def put_inserted(self, dst: str, src: str, is_new: np.ndarray,
                     arr: np.ndarray) -> None:
        """Chunk-wise splice: ``arr[~is_new] == get(src)``, the new rows at
        the ``is_new`` positions.  A source chunk with no insertion point
        inside it is aliased (no write); inserted runs and the chunks a
        splice point falls inside are written fresh, in chunks of this
        store's size.  A source that does not match (absent, another row
        count, dtype or row shape) falls back to :meth:`put`."""
        with self._lock:
            src_man = self._manifests.get(src)
        is_new = np.asarray(is_new, dtype=bool)
        arr = np.ascontiguousarray(arr)
        trail = tuple(int(d) for d in arr.shape[1:])
        if (src_man is None or len(is_new) != len(arr)
                or int((~is_new).sum()) != src_man.rows
                or str(arr.dtype) != src_man.dtype
                or trail != src_man.trail):
            self.put(dst, arr)
            return
        old_pos = np.nonzero(~is_new)[0]      # where each source row landed
        row_bytes = int(arr.itemsize * int(np.prod(trail, dtype=np.int64)))
        rows_per = max(1, self.chunk_bytes // max(row_bytes, 1))
        self.release(dst)
        chunks: List[_Chunk] = []
        new_refs: List[str] = []

        def write_fresh(part: np.ndarray) -> None:
            for start in range(0, len(part), rows_per):
                piece = part[start:start + rows_per]
                payload = piece.tobytes()
                with self._lock:
                    path = self._next_path()
                self._write_chunk(path, payload, key=dst, index=len(chunks))
                chunks.append(_Chunk(path=path, key=dst, index=len(chunks),
                                     rows=len(piece), nbytes=len(payload)))

        cursor = 0    # next row of arr not yet registered
        off_old = 0   # source rows consumed
        for c in src_man.chunks:
            lo = int(old_pos[off_old])
            hi = int(old_pos[off_old + c.rows - 1]) + 1
            if lo > cursor:                  # new rows before this chunk
                write_fresh(arr[cursor:lo])
            if hi - lo == c.rows:            # no insertion inside: alias
                chunks.append(_Chunk(path=c.path, key=dst, index=len(chunks),
                                     rows=c.rows, nbytes=c.nbytes))
                new_refs.append(c.path)
            else:
                write_fresh(arr[lo:hi])
            cursor = hi
            off_old += c.rows
        if cursor < len(arr):
            write_fresh(arr[cursor:])
        with self._lock:
            for path in new_refs:
                self._file_refs[path] = self._file_refs.get(path, 0) + 1
            for c in chunks:
                self._file_refs.setdefault(c.path, 1)
            self._manifests[dst] = _Manifest(
                dtype=src_man.dtype, trail=trail, rows=len(arr),
                chunks=chunks)

    # -- read side -----------------------------------------------------------
    def _schedule(self, chunks: Iterable[_Chunk]) -> None:
        """Queue background loads for chunks not yet scheduled, admitting
        only what the shared budget has room for (a skipped chunk gets
        re-offered by the streaming window once space frees)."""
        for c in chunks:
            with self._lock:
                if c.path in self._futures:
                    continue
                if not self.io_account.fits(c.nbytes):
                    continue
                self.io_account.reserve(c.nbytes, "chunk")
                self._resident += c.nbytes
                self.stats.peak_resident_bytes = max(
                    self.stats.peak_resident_bytes, self._resident)
                fut = self._pool.submit(self._load_task, c)
                self._futures[c.path] = fut

    def _load_task(self, chunk: _Chunk):
        # re-check the budget at execution time: a checkpoint hold that
        # landed after admission shrinks the window instead of overshooting
        if not self.io_account.fits(0):
            return _SKIPPED
        return self._read_chunk(chunk)

    def _acquire(self, chunk: _Chunk) -> Tuple[bytes, bool]:
        """One chunk's payload plus whether a scheduled load served it."""
        with self._lock:
            fut = self._futures.pop(chunk.path, None)
        if fut is None:
            with self._lock:
                self.stats.prefetch_misses += 1
            return self._read_chunk(chunk), False
        try:
            data = fut.result()
        finally:
            with self._lock:
                self._resident -= chunk.nbytes
            self.io_account.release(chunk.nbytes)
        if data is _SKIPPED:
            with self._lock:
                self.stats.prefetch_misses += 1
            return self._read_chunk(chunk), False
        with self._lock:
            self.stats.prefetch_hits += 1
        return data, True

    def get(self, key: str) -> np.ndarray:
        with self._lock:
            man = self._manifests.get(key)
        if man is None:
            raise StoreError(f"unknown store key {key!r}")
        dtype = np.dtype(man.dtype)
        out = np.empty((man.rows,) + man.trail, dtype=dtype)
        off = 0
        for i, c in enumerate(man.chunks):
            # streaming window: schedule the next chunks while copying this
            # one out (the background thread overlaps the disk reads)
            self._schedule(man.chunks[i + 1:i + 1 + self.lookahead])
            data, _ = self._acquire(c)
            out[off:off + c.rows] = np.frombuffer(
                data, dtype=dtype).reshape((c.rows,) + man.trail)
            off += c.rows
        return out

    def get_chunks(self, key: str):
        """The ``get`` loop, yielded per chunk: a consumer's peak working
        set is one chunk (plus the prefetch window), never the key.  The
        yielded arrays are read-only views over the chunk payloads."""
        with self._lock:
            man = self._manifests.get(key)
        if man is None:
            raise StoreError(f"unknown store key {key!r}")
        dtype = np.dtype(man.dtype)
        for i, c in enumerate(man.chunks):
            self._schedule(man.chunks[i + 1:i + 1 + self.lookahead])
            data, _ = self._acquire(c)
            yield np.frombuffer(data, dtype=dtype).reshape(
                (c.rows,) + man.trail)

    def stream_put(self, key: str, dtype, trail: Tuple[int, ...] = ()):
        """An appendable writer that flushes chunk files incrementally at
        ``chunk_bytes`` granularity, so a producer filtering one stream
        into another never holds either side whole."""
        return _ChunkStreamWriter(self, key, dtype, trail)

    def prefetch(self, keys: Sequence[str]) -> None:
        """Warm the head of each key so the next round's first reads hit
        (the rest streams through the per-``get`` lookahead window)."""
        for key in keys:
            with self._lock:
                man = self._manifests.get(key)
            if man is not None:
                self._schedule(man.chunks[:self.lookahead])

    # -- lifecycle -----------------------------------------------------------
    def release(self, key: str) -> None:
        prefix = key + "/"
        dead: List[str] = []
        with self._lock:
            names = [k for k in self._manifests
                     if k == key or k.startswith(prefix)]
            for name in names:
                man = self._manifests.pop(name)
                for c in man.chunks:
                    fut = self._futures.pop(c.path, None)
                    if fut is not None:
                        fut.cancel()
                        self._resident -= c.nbytes
                        self.io_account.release(c.nbytes)
                    self._file_refs[c.path] = \
                        self._file_refs.get(c.path, 1) - 1
                    if self._file_refs[c.path] <= 0:
                        del self._file_refs[c.path]
                        dead.append(c.path)
        for path in dead:
            with contextlib.suppress(OSError):
                os.remove(path)

    @property
    def resident_bytes(self) -> int:
        return self._resident

    def close(self) -> None:
        self._pool.shutdown(wait=True, cancel_futures=True)
        with self._lock:
            self._futures.clear()
            self._resident = 0


class _ChunkStreamWriter:
    """Chunked-store ``stream_put`` writer: appended rows are cut into
    chunk files as soon as a full chunk accumulates, and the manifest is
    registered atomically at ``close()`` — until then the key keeps its
    previous contents, so a round can stream-filter a key into its
    successor while the predecessor is still being read."""

    def __init__(self, store: ChunkedDiskStore, key: str, dtype,
                 trail: Tuple[int, ...]):
        self._store = store
        self._key = key
        self._dtype = np.dtype(dtype)
        self._trail = tuple(int(d) for d in trail)
        row_bytes = int(self._dtype.itemsize
                        * int(np.prod(self._trail, dtype=np.int64)))
        self._rows_per = max(1, store.chunk_bytes // max(row_bytes, 1))
        self._pending: List[np.ndarray] = []
        self._pending_rows = 0
        self._chunks: List[_Chunk] = []
        self._rows = 0
        self._closed = False

    @property
    def rows(self) -> int:
        return self._rows + self._pending_rows

    def append(self, arr: np.ndarray) -> None:
        part = np.ascontiguousarray(
            np.asarray(arr, self._dtype).reshape((-1,) + self._trail))
        if not len(part):
            return
        self._pending.append(part)
        self._pending_rows += len(part)
        while self._pending_rows >= self._rows_per:
            self._flush(self._rows_per)

    def _flush(self, rows: int) -> None:
        buf = (self._pending[0] if len(self._pending) == 1
               else np.concatenate(self._pending))
        part, rest = buf[:rows], buf[rows:]
        self._pending = [rest] if len(rest) else []
        self._pending_rows = len(rest)
        payload = np.ascontiguousarray(part).tobytes()
        store = self._store
        with store._lock:
            path = store._next_path()
        store._write_chunk(path, payload, key=self._key,
                           index=len(self._chunks))
        self._chunks.append(_Chunk(path=path, key=self._key,
                                   index=len(self._chunks), rows=len(part),
                                   nbytes=len(payload)))
        self._rows += len(part)

    def close(self) -> None:
        if self._closed:
            return
        self._closed = True
        if self._pending_rows:
            self._flush(self._pending_rows)
        store = self._store
        store.release(self._key)
        with store._lock:
            for c in self._chunks:
                store._file_refs[c.path] = 1
            store._manifests[self._key] = _Manifest(
                dtype=str(self._dtype), trail=self._trail, rows=self._rows,
                chunks=self._chunks)

    def __enter__(self) -> "_ChunkStreamWriter":
        return self

    def __exit__(self, *exc) -> None:
        if exc[0] is None:
            self.close()
