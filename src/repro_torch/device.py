"""Device resolution and the host-sync counter shared by the round loops.

Entry points take ``device=None``, meaning the CUDA card; without CUDA they
raise unless the caller asked for the CPU explicitly, so a CPU run is never
mistaken for a device run.

Every host loop over device tensors (one removal round per iteration) reads
its loop-control flags through :func:`host_read`, the one place a round
loop waits for the device; a loop that needs a whole tensor on the host (the
per-part seed path's removed mask) reads it through :func:`host_array`.
``SYNCS`` counts those waits so a run can report them (``chip_smoke.py``
prints them per phase).

Spans and counters of the serving path record only while a profiler
records (``torch.profiler.profile``, which is how an operator turns them
on; there is no other switch).  :func:`span` marks a named range on the
profiler's host timeline at function scope, as an aten op is marked, so
it leaves no mirror among the device's events; a kernel belongs to the
span that was open when its launching call ran (the profiler's
correlation id joins the two).  Without a profiler it returns one shared
no-op.  :func:`traced` makes a whole function's call such a span and, with
a ``phase`` (``"prefill"``, ``"decode"``), the phase in which
:func:`count_kept` keeps each MoE routing's ``keep`` mask as it is; the
masks are summed only when :func:`read_counters` reads the slots kept per
phase, in one host read counted in ``SYNCS``, so counting launches nothing
and waits for nothing while the profiler records.  :func:`reset_counters`
empties them.  The span names in use are listed in ``launch/serve.py``.
"""

from __future__ import annotations

import contextlib
import functools

import numpy as np
import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

SYNCS = 0
_KEPT: dict = {}        # phase -> MoE slots kept, read so far
_PENDING: dict = {}     # phase -> [keep masks not read yet]
_PHASE = None           # the serving phase of the traced call running
_NO_SPAN = contextlib.nullcontext()


def resolve_device(device=None) -> torch.device:
    """``None`` -> ``cuda``; raise when CUDA is requested but absent."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run the plain "
            "PyTorch versions on the host")
    return dev


def host_read(*values: torch.Tensor) -> list:
    """Copy scalar device tensors to Python numbers in ONE transfer (one
    device synchronisation), counted in ``SYNCS``."""
    global SYNCS
    SYNCS += 1
    return torch.stack([v.reshape(()).to(torch.int64) for v in values]).tolist()


def host_array(value: torch.Tensor) -> np.ndarray:
    """Copy one device tensor to a numpy array (one device synchronisation),
    counted in ``SYNCS``."""
    global SYNCS
    SYNCS += 1
    return value.cpu().numpy()


def span(name: str):
    """A profiler range ``name`` (function scope) while a profiler
    records, else a shared no-op context."""
    return _RecordFunctionFast(name) if _profiler_enabled() else _NO_SPAN


def traced(name: str, phase: str | None = None):
    """Decorator: each call a :func:`span` ``name``; with ``phase``, the
    slots that :func:`count_kept` sees during the call count in it."""
    def wrap(fn):
        @functools.wraps(fn)
        def call(*args, **kwargs):
            if not _profiler_enabled():
                return fn(*args, **kwargs)
            global _PHASE
            outer, _PHASE = _PHASE, phase or _PHASE
            try:
                with _RecordFunctionFast(name):
                    return fn(*args, **kwargs)
            finally:
                _PHASE = outer
        return call
    return wrap


def count_kept(keep: torch.Tensor) -> None:
    """Keep a MoE routing's ``keep`` mask, to be summed when the counters
    are read, under the phase of the traced call running; nothing outside
    a phase or without a profiler."""
    if _PHASE is not None and _profiler_enabled():
        _PENDING.setdefault(_PHASE, []).append(keep)


def read_counters() -> dict:
    """``{phase: MoE slots kept}``: the masks kept since the last read
    are summed in one host read (counted in ``SYNCS``)."""
    if _PENDING:
        phases = list(_PENDING)
        sums = host_read(*(torch.cat([m.reshape(-1) for m in _PENDING[p]])
                           .sum() for p in phases))
        _PENDING.clear()
        for phase, n in zip(phases, sums):
            _KEPT[phase] = _KEPT.get(phase, 0) + n
    return dict(_KEPT)


def reset_counters() -> None:
    """Forget every counter, read or not."""
    _KEPT.clear()
    _PENDING.clear()


def release_cached_blocks(exc: BaseException) -> None:
    """After a device OOM, return the caching allocator's free blocks to the
    driver, so a retry's smaller launch does not fail on blocks the failed
    one left cached.  A no-op for other errors and before CUDA starts."""
    if isinstance(exc, torch.OutOfMemoryError) and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
