"""peak_mem_gib (GiB, read by the benchmark from the card's allocator):
``torch.cuda.max_memory_allocated()`` over the window, reset at its
start."""


def read(run):
    if run.window_peak_bytes is None:
        return None
    return run.window_peak_bytes / 2 ** 30
