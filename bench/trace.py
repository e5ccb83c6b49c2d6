"""The traced run: ``torch.profiler`` over the window, read into a
``Trace`` that the per-layer readers take their numbers from.

The benchmark records its own spans (``bench.window`` around the window,
``bench.prefill`` and ``bench.decode_step`` around each call of the
program's ``prefill`` and ``decode_step`` that ``serve.generate`` makes);
the program has none yet.  The profiler's events are read raw
(``kineto_results.events()``, as ``chip_smoke.py`` does: ``key_averages()``
takes minutes on a trace this long): every device operation (kernels,
copies, fills), the runtime call that launched each (by correlation id),
and the host's ops.
"""

from __future__ import annotations

import bisect
import contextlib
import dataclasses

NO_HOST_OP = "(no host op)"
TOP = 10                  # entries of each list of the breakdown
NAME_CHARS = 200          # a kernel's name is cut to this many characters
SPANNED = ("prefill", "decode_step")


@dataclasses.dataclass
class Trace:
    """Times in ns on the profiler's clock."""
    device_ops: list      # (name, start, end, correlation id), by start
    launches: dict        # correlation id -> start of the launching call
    spans: dict           # span name -> [(start, end)] (the benchmark's)
    host_ops: list        # (start, end, name) of the host's ops, by start
    window: tuple         # (start, end) of span bench.window

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    def kernels(self) -> list:
        """Device operations that are kernel launches (not copies or
        fills)."""
        return [op for op in self.device_ops
                if not op[0].startswith(("Memcpy", "Memset"))]

    def busy_intervals(self) -> list:
        """The union of the device's operations inside the window, as
        disjoint (start, end) intervals."""
        lo, hi = self.window
        out = []
        for _, s, e, _ in self.device_ops:
            s, e = max(s, lo), min(e, hi)
            if e <= s:
                continue
            if out and s <= out[-1][1]:
                out[-1][1] = max(out[-1][1], e)
            else:
                out.append([s, e])
        return out

    def busy_s(self) -> float:
        return sum(e - s for s, e in self.busy_intervals()) / 1e9

    def kernel_s(self, patterns) -> float:
        """Summed device time of the kernels whose name holds any of
        ``patterns``."""
        return sum(e - s for n, s, e, _ in self.kernels()
                   if any(p in n for p in patterns)) / 1e9

    def launched_in(self, span: str) -> int:
        """Kernels whose launching call lies inside a span ``span``."""
        ranges = sorted(self.spans.get(span, ()))
        starts = [r[0] for r in ranges]
        n = 0
        for _, _, _, corr in self.kernels():
            t = self.launches.get(corr)
            if t is None:
                continue
            i = bisect.bisect_right(starts, t) - 1
            n += i >= 0 and t <= ranges[i][1]
        return n

    def host_op_at(self, t: int) -> str:
        """The innermost host op running at ``t``: of those that started by
        then and had not ended, the one that started last."""
        i = bisect.bisect_right(self._host_starts, t)
        for s, e, name in reversed(self.host_ops[max(0, i - 2000):i]):
            if e >= t:
                return name
        return NO_HOST_OP

    def __post_init__(self):
        self._host_starts = [op[0] for op in self.host_ops]

    def breakdown(self) -> dict:
        """The device operations that took the most time, and the idle
        gaps summed by the host op running where each gap starts."""
        by_name: dict = {}
        for n, s, e, _ in self.device_ops:
            by_name[n[:NAME_CHARS]] = by_name.get(n[:NAME_CHARS], 0) + e - s
        gaps: dict = {}
        lo, hi = self.window
        edges = [(lo, lo)] + [tuple(iv) for iv in self.busy_intervals()] \
            + [(hi, hi)]
        for (_, a), (b, _) in zip(edges, edges[1:]):
            if b > a:
                name = self.host_op_at(a)
                gaps[name] = gaps.get(name, 0) + b - a

        def top(d):
            return [[k, v / 1e9] for k, v in
                    sorted(d.items(), key=lambda kv: -kv[1])[:TOP]]

        return {"device_ops": top(by_name), "idle_gaps": top(gaps)}


def read_events(events, device_type_cuda) -> Trace:
    """A ``Trace`` from kineto events (``prof.profiler.kineto_results
    .events()``)."""
    device_ops, launches, spans, host_ops = [], {}, {}, []
    for e in events:
        name, start = e.name(), e.start_ns()
        end = start + e.duration_ns()
        if e.device_type() == device_type_cuda:
            if name.startswith("bench."):      # a span's mirror on the device
                continue
            device_ops.append((name, start, end, e.correlation_id()))
        elif name.startswith("cu"):
            launches[e.correlation_id()] = start
        else:
            if name.startswith("bench."):
                spans.setdefault(name, []).append((start, end))
            host_ops.append((start, end, name))
    device_ops.sort(key=lambda op: op[1])
    host_ops.sort()
    window = spans.get("bench.window", [(0, 0)])[0]
    return Trace(device_ops, launches, spans, host_ops, window)


@contextlib.contextmanager
def _spans_around(module, names):
    """``module.<name>`` wrapped in a profiler span ``bench.<name>`` for
    each name, restored on exit."""
    import torch

    saved = {n: getattr(module, n) for n in names}

    def spanned(n, fn):
        def call(*args, **kwargs):
            with torch.profiler.record_function(f"bench.{n}"):
                return fn(*args, **kwargs)
        return call

    try:
        for n, fn in saved.items():
            setattr(module, n, spanned(n, fn))
        yield
    finally:
        for n, fn in saved.items():
            setattr(module, n, fn)


class Recorder:
    """``with Recorder(on) as rec:`` profiles the block when ``on``; then
    ``rec.trace`` holds its ``Trace`` (None when off)."""

    def __init__(self, on: bool):
        self.on = on
        self.trace = None
        self._stack = contextlib.ExitStack()

    def __enter__(self):
        if self.on:
            import torch
            from repro_torch.models import transformer

            acts = [torch.profiler.ProfilerActivity.CPU]
            if torch.cuda.is_available():
                acts.append(torch.profiler.ProfilerActivity.CUDA)
            self._prof = self._stack.enter_context(
                torch.profiler.profile(activities=acts))
            self._stack.enter_context(_spans_around(transformer, SPANNED))
            self._stack.enter_context(
                torch.profiler.record_function("bench.window"))
        return self

    def __exit__(self, *exc):
        self._stack.close()
        if self.on and exc[0] is None:
            from torch.autograd import DeviceType

            self.trace = read_events(
                self._prof.profiler.kineto_results.events(), DeviceType.CUDA)
        return False
