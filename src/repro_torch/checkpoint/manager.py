"""Checkpointing: atomic, keep-k, restart-safe (port of
``repro.checkpoint.manager``, same on-disk layout).

Format: one directory per step, ``step_XXXXXXXXXX``, holding
``arrays.npz`` (flattened leaves ``a0``, ``a1``, ...) and ``manifest.json``
(step, leaf paths, dtypes, shapes, payload sha256, user metadata).  Writes
go to ``<dir>.tmp`` then ``os.rename``, so a crash mid-write never corrupts
the latest checkpoint; the ``"checkpoint-write"`` fault site sits between
the payload write and the rename.  ``AsyncWriter`` moves serialization off
the caller's thread.

Integrity: the manifest records the sha256 of ``arrays.npz`` as written, so
a payload truncated after the rename is detected at restore time;
``restore(step=None)`` then falls back to the next-newest valid snapshot,
raising :class:`CheckpointCorruptionError` only when none survives.  A
mismatch against the caller's ``like`` tree raises
:class:`CheckpointStructureError` (a caller bug: no fallback).

Trees are nested dicts, lists and tuples; dict keys are walked in sorted
order and leaf paths join keys and indices with ``/`` (``"sup"``,
``"opt/mu/0"``), as the JAX package's tree walk gives them, so either
package restores the other's snapshots.  Tensor leaves are copied to the
host; a bf16 tensor is stored as its 16-bit pattern with dtype
``"bfloat16"`` and restored as a bf16 tensor.  ``restore(like=...)`` puts
each tensor leaf on its ``like`` leaf's device; ``shardings=``, a matching
tree of ``torch.device``s (or ``None`` leaves), places each leaf where it
says, the one-card counterpart of the JAX package's tree of shardings.
"""

from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
import warnings
from typing import Any, Optional

import numpy as np
import torch

from repro_torch.core import faults
from repro_torch.tree import flatten_with_paths, map_leaves, unflatten_like

_BF16 = "bfloat16"


class CheckpointError(RuntimeError):
    """Base class for checkpoint restore failures."""


class CheckpointCorruptionError(CheckpointError):
    """A snapshot's payload is unreadable or fails its manifest checksum."""


class CheckpointStructureError(CheckpointError):
    """A snapshot does not match the structure of the caller's ``like``
    tree (leaf count or leaf shape) — a caller/config bug, not corruption."""


def _to_host(x) -> np.ndarray:
    """A leaf as a numpy array; a bf16 tensor as its uint16 bit pattern."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy().view(np.uint16)
        return x.numpy()
    return np.asarray(x)


def _from_savable(arr: np.ndarray, dtype_name: str):
    if dtype_name == _BF16:
        return torch.from_numpy(arr.view(np.int16).copy()).view(
            torch.bfloat16)
    return arr


def atomic_file_write(path: str, payload: bytes) -> None:
    """Write ``payload`` to ``<path>.tmp`` then ``os.replace``: a crash at
    any point leaves the previous intact file or a stale ``.tmp``, never a
    torn ``path``."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.write(payload)
    os.replace(tmp, path)


def save(ckpt_dir: str, step: int, tree: Any, metadata: Optional[dict] = None,
         keep: int = 3) -> str:
    """Atomic save of a tree; prunes to the newest ``keep`` checkpoints.

    The payload is serialized in memory first so the manifest can record
    its sha256 — the checksum covers exactly the bytes handed to the OS.
    """
    os.makedirs(ckpt_dir, exist_ok=True)
    final = os.path.join(ckpt_dir, f"step_{step:010d}")
    tmp = final + ".tmp"
    if os.path.exists(tmp):
        shutil.rmtree(tmp)
    os.makedirs(tmp)
    paths, leaves = flatten_with_paths(tree)
    arrays = {f"a{i}": _to_host(x) for i, x in enumerate(leaves)}
    buf = io.BytesIO()
    np.savez(buf, **arrays)
    payload = buf.getvalue()
    npz_path = os.path.join(tmp, "arrays.npz")
    with open(npz_path, "wb") as f:
        f.write(payload)
    # deterministic torn-write / crash injection between payload and commit
    faults.check(faults.CHECKPOINT_WRITE, step=step, path=npz_path,
                 dir=ckpt_dir)
    manifest = {
        "step": step,
        "paths": paths,
        "dtypes": [_BF16 if isinstance(x, torch.Tensor)
                   and x.dtype == torch.bfloat16 else str(a.dtype)
                   for x, a in zip(leaves, arrays.values())],
        "shapes": [list(a.shape) for a in arrays.values()],
        "arrays_sha256": hashlib.sha256(payload).hexdigest(),
        "metadata": metadata or {},
    }
    with open(os.path.join(tmp, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    if os.path.exists(final):
        shutil.rmtree(final)
    os.rename(tmp, final)
    _prune(ckpt_dir, keep)
    return final


def _prune(ckpt_dir: str, keep: int) -> None:
    steps = sorted(all_steps(ckpt_dir))
    for s in steps[:-keep] if keep > 0 else []:
        shutil.rmtree(os.path.join(ckpt_dir, f"step_{s:010d}"),
                      ignore_errors=True)


def all_steps(ckpt_dir: str) -> list[int]:
    if not os.path.isdir(ckpt_dir):
        return []
    out = []
    for name in os.listdir(ckpt_dir):
        if name.startswith("step_") and not name.endswith(".tmp"):
            try:
                out.append(int(name[5:]))
            except ValueError:
                pass
    return sorted(out)


def latest_step(ckpt_dir: str) -> Optional[int]:
    steps = all_steps(ckpt_dir)
    return max(steps) if steps else None


def _load_step(ckpt_dir: str, step: int) -> tuple[list, dict]:
    """Read + integrity-check one snapshot; returns (leaves, manifest).

    Raises :class:`CheckpointCorruptionError` on any unreadable file or a
    payload whose sha256 disagrees with the manifest.  Snapshots without an
    ``arrays_sha256`` key load unchecked.
    """
    d = os.path.join(ckpt_dir, f"step_{step:010d}")
    try:
        with open(os.path.join(d, "manifest.json")) as f:
            manifest = json.load(f)
    except (OSError, ValueError) as e:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} under {ckpt_dir}: unreadable manifest "
            f"({e})") from e
    try:
        with open(os.path.join(d, "arrays.npz"), "rb") as f:
            payload = f.read()
    except OSError as e:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} under {ckpt_dir}: unreadable payload "
            f"({e})") from e
    want = manifest.get("arrays_sha256")
    if want is not None:
        got = hashlib.sha256(payload).hexdigest()
        if got != want:
            raise CheckpointCorruptionError(
                f"checkpoint step {step} under {ckpt_dir}: arrays.npz sha256 "
                f"mismatch (manifest {want[:12]}…, on disk {got[:12]}… — "
                f"truncated or torn write)")
    try:
        data = np.load(io.BytesIO(payload))
        leaves = [_from_savable(data[f"a{i}"], manifest["dtypes"][i])
                  for i in range(len(manifest["paths"]))]
    except Exception as e:
        raise CheckpointCorruptionError(
            f"checkpoint step {step} under {ckpt_dir}: undecodable payload "
            f"({e})") from e
    return leaves, manifest


def _cast_like(ref, arr, device=None):
    """``arr`` in the type and dtype of the ``like`` leaf ``ref``: a tensor
    leaf on ``device``, or else on ``ref``'s device; any other leaf given a
    ``device`` becomes a tensor there."""
    if isinstance(ref, torch.Tensor):
        t = arr if isinstance(arr, torch.Tensor) else torch.from_numpy(arr)
        return t.to(device=ref.device if device is None else device,
                    dtype=ref.dtype)
    if isinstance(arr, torch.Tensor):
        arr = arr.float().numpy()
    arr = arr.astype(ref.dtype) if hasattr(ref, "dtype") else arr
    return arr if device is None else torch.as_tensor(arr, device=device)


def restore(ckpt_dir: str, like: Any = None, step: Optional[int] = None,
            shardings: Any = None) -> tuple[Any, dict]:
    """Restore a snapshot; returns ``(tree, metadata)``.

    With ``like`` given, leaves are validated against its structure
    (:class:`CheckpointStructureError` on leaf-count or shape mismatch) and
    cast to its leaf types, each tensor leaf on its ``like`` leaf's device.
    ``shardings``, a tree matching ``like`` whose leaves are
    ``torch.device``s or ``None``, places each leaf on the device given
    (``None``: where its ``like`` leaf lies).  With ``like=None`` the
    snapshot is returned as a flat ``{path: array}`` dict — the form the
    round journal uses.

    With ``step=None`` (latest), a snapshot that fails its integrity check
    falls back to the next-newest one (each skip warns); an explicit
    ``step`` never falls back.
    """
    if step is not None:
        candidates = [step]
    else:
        candidates = sorted(all_steps(ckpt_dir), reverse=True)
        if not candidates:
            raise FileNotFoundError(f"no checkpoints under {ckpt_dir}")
    last_err: Optional[CheckpointCorruptionError] = None
    leaves = manifest = None
    for s in candidates:
        try:
            leaves, manifest = _load_step(ckpt_dir, s)
            break
        except CheckpointCorruptionError as e:
            last_err = e
            if step is not None:
                raise
            warnings.warn(f"skipping corrupt checkpoint: {e}", stacklevel=2)
    if manifest is None:
        raise CheckpointCorruptionError(
            f"no intact checkpoint under {ckpt_dir} "
            f"({len(candidates)} candidate(s) failed)") from last_err
    if like is None:
        return dict(zip(manifest["paths"], leaves)), manifest["metadata"]
    _, flat_like = flatten_with_paths(like)
    if len(flat_like) != len(leaves):
        raise CheckpointStructureError(
            f"checkpoint step {manifest['step']} holds {len(leaves)} leaves "
            f"but the restore target has {len(flat_like)} — wrong tree "
            f"structure for this checkpoint")
    flat_dev = (flatten_with_paths(shardings)[1] if shardings is not None
                else [None] * len(leaves))
    if len(flat_dev) != len(leaves):
        raise CheckpointStructureError(
            f"shardings has {len(flat_dev)} leaves but the restore target "
            f"has {len(flat_like)}")
    out = []
    for i, (ref, arr, sh) in enumerate(zip(flat_like, leaves, flat_dev)):
        arr = _cast_like(ref, arr, sh)
        if tuple(arr.shape) != tuple(ref.shape):
            raise CheckpointStructureError(
                f"checkpoint step {manifest['step']} leaf "
                f"{manifest['paths'][i]!r} has shape {tuple(arr.shape)} but "
                f"the restore target expects {tuple(ref.shape)}")
        out.append(arr)
    return unflatten_like(like, out), manifest["metadata"]


class AsyncWriter:
    """Write-behind checkpointing: snapshot on the caller thread (host copy),
    serialize on a worker thread; a worker's error surfaces at the next
    :meth:`wait` (or :meth:`save`)."""

    def __init__(self, ckpt_dir: str, keep: int = 3):
        self.ckpt_dir = ckpt_dir
        self.keep = keep
        self._thread: Optional[threading.Thread] = None
        self.last_error: Optional[BaseException] = None

    def save(self, step: int, tree: Any, metadata: Optional[dict] = None):
        self.wait()
        host_tree = map_leaves(_host_copy, tree)

        def work():
            try:
                save(self.ckpt_dir, step, host_tree, metadata, self.keep)
            except BaseException as e:  # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=work, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            err, self.last_error = self.last_error, None
            raise err


def _host_copy(x):
    """A host copy the caller may overwrite after ``AsyncWriter.save``."""
    if isinstance(x, torch.Tensor):
        return x.detach().to("cpu", copy=True)
    return np.array(x, copy=True)
