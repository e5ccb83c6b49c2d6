"""Repo-native configuration for the port's trusscheck rules.

The rules are generic AST passes; everything that names the PORT's
conventions — which modules are the round loops, which calls put tensors on
the card, which kernel bindings take a buffer to write through, which APIs
carry the shape-cache discipline, where the fault-site registry lives — is
collected here, so adding a module or an API is a one-line config change,
not a rule rewrite.  The reference package keeps the same table for the
JAX stack (``repro.analysis.config``); the keys whose meaning changed with
the port (TRK101, TRK105, TRK107) say how.
"""

from __future__ import annotations

import dataclasses
import re
from typing import Dict, Tuple


@dataclasses.dataclass
class CheckConfig:
    # --- TRK102: numeric config names whose 0 is a meaningful value, so
    # bare truthiness (`if budget:`) silently conflates 0 with None — the
    # falsy `if memory_budget:` fallback class.  Matched as fullmatch
    # against the identifier (parameters, locals and attribute names);
    # parameters annotated `int | None` / `Optional[int]` are covered
    # regardless of name.
    numeric_config_patterns: Tuple[str, ...] = (
        r".*budget.*", r".*_every", r"every", r".*multiple", r".*capacity",
        r".*retries", r".*chunks?", r".*interval", r".*limit", r"max_seq",
        r".*_seed", r"seed", r"n_devices",
    )

    # --- TRK103: bare asserts are no-ops under `python -O`.  Everything
    # under these roots is library code; tests keep their asserts.
    library_roots: Tuple[str, ...] = ("src/repro_torch",)

    # --- TRK101: calls that consume a value, so that a second use of it
    # reads something already spent.  Torch has no donate_argnums; the
    # port's consuming calls are
    # * a method that consumes its receiver: a `PendingPeel` handle's
    #   `result()` clears its finalize before running it, so a second
    #   `result()` (a retry) can never re-run the device work;
    # * a kernel binding that writes through some of its arguments while
    #   it reads others: the same buffer at a read and at a write position
    #   of one call races on the card.  Keyed by the binding's trailing
    #   name -> (positions read, positions written through).
    consuming_methods: Tuple[str, ...] = ("result",)
    write_through_bindings: Dict[str, Tuple[Tuple[int, ...],
                                            Tuple[int, ...]]] = (
        dataclasses.field(default_factory=lambda: {
            # kernels/frontier_peel/kernel.py: (sup, alive, rm, tris,
            # n_rows) read, (tris_out, n_rows_out) written
            "fused_round_live": ((0, 1, 2, 3, 4), (5, 6)),
        }))

    # --- TRK104: APIs that key a launch shape per operand shape and
    # therefore carry the shape-cache / shape-ladder discipline (the
    # drivers' `OocStats.compiles` counts launch shapes through it).  A
    # call to one of these inside a per-round / per-level loop without the
    # keyword leaves its shapes uncounted.
    shape_disciplined_apis: Dict[str, Tuple[str, ...]] = dataclasses.field(
        default_factory=lambda: {
            "peel_classes_batched": ("shape_cache",),
            "local_threshold_peel": ("shape_cache",),
            "build_partition_batch": ("shape_ladder", "lane_capacity"),
        })

    # --- TRK105: modules whose round loops are the latency-critical path;
    # host syncs (.item()/.tolist()/.cpu()/.numpy(), int()/float()/bool(),
    # np.asarray, a tensor as a branch test) on device tensors inside
    # their loops stall the launch queue.
    hot_modules: Tuple[str, ...] = (
        "core/bottom_up.py", "core/top_down.py", "core/peel.py",
        "core/store.py", "core/maintain.py", "core/kcore.py",
        "kernels/frontier_peel/ops.py",
    )
    # Calls whose results are device tensors (module-local torch.compile /
    # torch.jit.script bindings are discovered from the AST, and so are
    # `.to(<device>)`, `.cuda()` and torch factories given `device=`).
    device_producers: Tuple[str, ...] = (
        # the kernel bindings
        "fused_round_live", "fused_round", "triangle_count",
        "flash_attention", "embedding_bag",
        # uploads and the device-side peels that return tensors
        "_put", "_upload_lanes", "peel_threshold", "peel_threshold_dense",
        "peel_threshold_fused", "peel_classes_fused",
        "peel_classes_batched_sharded", "local_threshold_peel_sharded",
        "_frontier_round", "_dense_round",
    )
    # The sanctioned reads, counted in `repro_torch.device.SYNCS` (scalars
    # through `host_read`, a whole tensor through `host_array`): never
    # flagged, and their results are host values.
    sanctioned_syncs: Tuple[str, ...] = ("host_read", "host_array")
    # Argument names that denote a device in `.to(...)`.
    device_arg_pattern: str = r"(.*_)?dev(ice)?"

    # --- TRK106: the fault-site registry module and the functions that
    # must carry a `faults.check(...)` hook (core/faults.py is the port's
    # own copy of the registry).  Keyed by (module suffix, function name)
    # -> required site constant name.
    faults_module: str = "core/faults.py"
    required_fault_hooks: Dict[Tuple[str, str], str] = dataclasses.field(
        default_factory=lambda: {
            ("core/peel.py", "peel_classes_batched"): "DISPATCH",
            ("core/peel.py", "local_threshold_peel"): "DISPATCH",
            ("core/peel.py", "PendingPeel.result"): "FINALIZE",
            ("core/bottom_up.py", "_partition_rounds"): "PARTITIONER",
            ("core/bottom_up.py", "_support_credit_triples"): "SUPPORT",
            ("core/maintain.py", "truss_maintain"): "MAINTAIN",
            ("checkpoint/manager.py", "save"): "CHECKPOINT_WRITE",
            ("core/store.py",
             "ChunkedDiskStore._read_chunk"): "CHUNK_READ",
            ("core/store.py",
             "ChunkedDiskStore._write_chunk"): "CHUNK_WRITE",
        })
    # Modules whose dispatch-capable peel calls must name themselves at
    # the fault sites (fault_ctx=) so injection plans can target them.
    fault_instrumented_modules: Tuple[str, ...] = (
        "core/bottom_up.py", "core/top_down.py",
    )
    fault_instrumented_apis: Tuple[str, ...] = (
        "peel_classes_batched", "local_threshold_peel",
    )

    # --- TRK107: CUDA kernel-binding invariants.  A binding module under
    # these directories that loads a library through `build.library` must
    # guard each launch-sizing divisor with a typed raise or a ceil-div
    # (asserts vanish under -O), and compare a shared-memory estimate of
    # one block against the budget constant.
    kernel_globs: Tuple[str, ...] = ("kernels/",)
    smem_helper_pattern: str = r".*smem_bytes.*"
    smem_budget_pattern: str = r".*SMEM_BUDGET.*"
    # Parameter names of a launching function that size the launch.
    tile_param_pattern: str = r"b[a-z][a-z0-9]*|tile.*|block.*"

    def numeric_config_re(self) -> re.Pattern:
        return re.compile("|".join(f"(?:{p})"
                                   for p in self.numeric_config_patterns))

    def tile_param_re(self) -> re.Pattern:
        return re.compile(self.tile_param_pattern)


DEFAULT_CONFIG = CheckConfig()
