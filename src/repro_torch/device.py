"""Device resolution and the host-sync counter shared by the round loops.

Entry points take ``device=None``, meaning the CUDA card; without CUDA they
raise unless the caller asked for the CPU explicitly, so a CPU run is never
mistaken for a device run.

Every host loop over device tensors (one removal round per iteration) reads
its loop-control flags through :func:`host_read`, the one place a round
loop waits for the device; ``SYNCS`` counts those waits so a run can report
them (``chip_smoke.py`` prints them per phase).
"""

from __future__ import annotations

import torch

SYNCS = 0


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


def release_cached_blocks(exc: BaseException) -> None:
    """After a device OOM, return the caching allocator's free blocks to the
    driver, so a retry's smaller launch does not fail on blocks the failed
    one left cached.  A no-op for other errors and before CUDA starts."""
    if isinstance(exc, torch.OutOfMemoryError) and torch.cuda.is_initialized():
        torch.cuda.empty_cache()
