"""The program's own spans and counters, read from a traced run.

The serving path marks its layers with spans (``lm.prefill``,
``lm.decode_step``, ``lm.attn.core``, ``lm.moe.*``, ...) on the profiler's
host timeline while a profiler records; they arrive among the ``Trace``'s
host ops.  A device operation belongs to a span when the runtime call that
launched it (``Trace.launches``, by correlation id) started inside it.
Its MoE counter, the slots kept by phase, is read from
``repro_torch.device.read_counters()`` after the profiler stops.  A program without them (an older checkout) gives no spans
and no counters, and each reader then reads nothing.
"""

from __future__ import annotations

import bisect


def intervals(trace, name: str, within: str | None = None) -> list:
    """(start, end) of the host spans named ``name``, by start; with
    ``within``, only those that lie inside a span named ``within``."""
    own = [(s, e) for s, e, n in trace.host_ops if n == name]
    if within is None:
        return own
    outer = intervals(trace, within)
    starts = [s for s, _ in outer]
    kept = []
    for s, e in own:
        i = bisect.bisect_right(starts, s) - 1
        if i >= 0 and e <= outer[i][1]:
            kept.append((s, e))
    return kept


def _union(ranges) -> list:
    out = []
    for s, e in sorted(ranges):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


def device_s(trace, names, within: str | None = None) -> float:
    """Summed device time (kernels, copies and fills) of the operations
    launched inside any span named in ``names`` (each inside a ``within``
    span, when given); an operation is counted once however many of the
    spans hold its launch."""
    ranges = _union(r for n in names for r in intervals(trace, n, within))
    starts = [s for s, _ in ranges]
    total = 0
    for _, s, e, corr in trace.device_ops:
        t = trace.launches.get(corr)
        if t is None:
            continue
        i = bisect.bisect_right(starts, t) - 1
        if i >= 0 and t <= ranges[i][1]:
            total += e - s
    return total / 1e9


def kept_slots(phase: str) -> int | None:
    """The MoE slots the program kept in ``phase`` (``"prefill"`` or
    ``"decode"``) since its counters were last reset, or None when it
    counted none (or has no counters)."""
    from repro_torch import device

    read = getattr(device, "read_counters", None)
    if read is None:
        return None
    return read().get(phase)
