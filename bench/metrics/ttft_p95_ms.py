"""ttft_p95_ms (ms, host clock): the 95th percentile (numpy's linear
interpolation) over every request of the window of the time from its
batch's call to its first token on the host."""

import numpy as np


def read(run):
    times = [b.ttft_s for b in run.batches if b.ok for _ in range(b.requests)]
    if not times:
        return None
    return float(np.percentile(times, 95)) * 1e3
