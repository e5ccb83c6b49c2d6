"""idle_share.prefill (%, device trace): the share of the traced batches'
time in which no operation (kernel, copy or fill) ran on the card.  The
busy time is the union of the device's operations in the trace; the time
is what those batches take without the profiler, the median host wall of
the window's calls of the same shape (``Run.untraced_wall_s``): the
profiler's host activity lengthens the traced wall (a decode batch by
half) and not the device's work."""


def read(run):
    if run.trace is None or not run.trace.device_ops:
        return None
    wall = run.untraced_wall_s()
    if not wall:
        return None
    return 100.0 * (1.0 - run.trace.busy_s() / wall)
