"""Flop, byte and collective accounting of one step, by the ops it
dispatches (the port's counterpart of the JAX package's
``launch/hlo_analysis.py``, which walks post-SPMD HLO text).

The port has no HLO: it runs the step eagerly and counts what reaches the
dispatcher, on each device's local tensors (a ``DTensor`` op is counted as
the local op it becomes).  Eager mode runs every iteration of every loop
(microbatches, layers, attention chunks, ring steps), so no trip counts
are needed, unlike the reference's walker.

* ``flops``: matmul-like ops only (``mm``, ``bmm``, ``addmm``,
  ``baddbmm``, convolutions, SDPA), by ``torch.utils.flop_counter``'s
  formulas; elementwise work is ignored, as in the reference;
* ``dot_bytes``: those ops' operand and result bytes, the streamed-traffic
  proxy the reference uses as a lower bound on HBM traffic;
* ``collective_bytes`` / ``collective_counts`` under the reference's five
  names: all-gather, all-reduce, reduce-scatter and all-to-all (result
  bytes, as the reference counts them), and collective-permute for an
  all-to-all whose sends all go to one peer (the ring's ``ring_shift``:
  the bytes sent);
* the peak of the bytes the step allocates (``Counter.peak_bytes``):
  storages created by its ops while they live, outputs included.

``analyze(fn, *args)`` runs ``fn(*args)`` once under a ``Counter`` and
returns the reference's keys.
"""

from __future__ import annotations

import weakref

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map
from torch.utils.flop_counter import flop_registry

COLLECTIVE_OPS = ("all-gather", "all-reduce", "reduce-scatter",
                  "all-to-all", "collective-permute")

_c10d = torch.ops.c10d
_fn = torch.ops._c10d_functional
_COLLECTIVES = {
    "all_gather_into_tensor": "all-gather", "all_reduce": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "all_to_all_single": "all-to-all",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "alltoall_base_": "all-to-all", "alltoall_": "all-to-all",
}


def _nbytes(t) -> int:
    return t.numel() * t.element_size()


def _shape(x):
    return x.shape if isinstance(x, torch.Tensor) else x


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _storage_key(t):
    try:
        return t.untyped_storage()._cdata
    except (NotImplementedError, RuntimeError):
        return None


def _is_dtensor_type(t) -> bool:
    return t.__name__ == "DTensor" and t.__module__.startswith(
        "torch.distributed.tensor")


class Counter(TorchDispatchMode):
    """Counts the local ops of what runs inside it (see the module
    docstring).  A ``DTensor`` op is passed on (``NotImplemented``) so that
    the local op it becomes is the one counted; ops that ``DTensor`` runs
    under a fake mode of its own to propagate shardings are not counted."""

    def __init__(self):
        super().__init__()
        self.flops = 0
        self.dot_bytes = 0
        self.coll_bytes = {k: 0 for k in COLLECTIVE_OPS}
        self.coll_counts = {k: 0 for k in COLLECTIVE_OPS}
        self.ops = 0
        self.live_bytes = 0
        self.peak_bytes = 0
        self._live = {}              # storage pointer -> (weakref, bytes)
        self._fake = None

    def __enter__(self):
        from torch._guards import active_fake_mode

        self._fake = active_fake_mode()
        return super().__enter__()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch._guards import active_fake_mode

        if any(_is_dtensor_type(t) for t in types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if active_fake_mode() is not self._fake:
            return out
        self.ops += 1
        packet = func._overloadpacket
        count = flop_registry.get(packet)
        if count is not None:
            self.flops += count(*tree_map(_shape, args),
                                **tree_map(_shape, kwargs),
                                out_val=tree_map(_shape, out))
            self.dot_bytes += sum(_nbytes(t) for t in _tensors((args, out)))
        else:
            kind = _COLLECTIVES.get(packet.__name__)
            if kind is not None and packet in (
                    getattr(_c10d, packet.__name__, None),
                    getattr(_fn, packet.__name__, None)):
                self._collective(kind, packet.__name__, args, out)
        self._track(out, args)
        return out

    def _collective(self, kind, name, args, out):
        if name == "alltoall_base_":
            # (output, input, group, output_splits, input_splits, ...)
            sends = [int(s) for s in args[4]]
            if sends and sum(1 for s in sends if s) == 1:
                kind = "collective-permute"
                nbytes = _nbytes(args[1])
            else:
                nbytes = _nbytes(args[0])
        elif name.endswith("_") and name not in ("allreduce_",
                                                 "allreduce_coalesced_"):
            # c10d ops write into their first (output) argument
            nbytes = sum(_nbytes(t) for t in _tensors(args[0]))
        else:
            nbytes = sum(_nbytes(t) for t in _tensors(
                args[0] if name.startswith("allreduce") else out))
        self.coll_bytes[kind] += nbytes
        self.coll_counts[kind] += 1

    def _track(self, out, args=()):
        """Count each output storage that no input shares (a view or an
        in-place result allocates nothing) while it lives."""
        inputs = {_storage_key(t) for t in _tensors(args)}
        for t in _tensors(out):
            try:
                st = t.untyped_storage()
            except (NotImplementedError, RuntimeError):
                continue
            key = st._cdata
            if key in self._live or key in inputs:
                continue
            nbytes = st.nbytes()
            self._live[key] = (weakref.ref(st, self._freed(key)), nbytes)
            self.live_bytes += nbytes
            self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    def _freed(self, key):
        def cb(_ref):
            entry = self._live.pop(key, None)
            if entry is not None:
                self.live_bytes -= entry[1]
        return cb

    def result(self) -> dict:
        return {"flops": float(self.flops), "dot_bytes": float(self.dot_bytes),
                "collective_bytes": {k: float(v)
                                     for k, v in self.coll_bytes.items()},
                "collective_counts": {k: float(v)
                                      for k, v in self.coll_counts.items()}}


def analyze(fn, *args) -> dict:
    """Run ``fn(*args)`` once and count it: ``{"flops", "dot_bytes",
    "collective_bytes", "collective_counts"}`` (the reference's keys; the
    last two by the five collective names)."""
    with Counter() as c:
        fn(*args)
    return c.result()
