"""launches_per_step.decode (launches, device trace): kernels whose launch
lies inside one of the traced calls of the program's ``decode_step``, over
the number of those calls."""


def read(run):
    if run.trace is None:
        return None
    steps = len(run.trace.spans.get("bench.decode_step", ()))
    if not steps:
        return None
    n = run.trace.launched_in("bench.decode_step")
    return n / steps if n else None
