"""setup_s (s, host clock): from the process's start to the window's:
imports, CUDA's start, the weights made from the seed, any kernel build,
and the warm-up of the cell's shapes."""


def read(run):
    return run.setup_s
