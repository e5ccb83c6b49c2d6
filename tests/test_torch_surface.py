"""The public surface of ``repro_torch`` against ``repro``'s, name by name.

Both packages are walked with ``ast``.  Every public top-level name of each
``src/repro`` module (functions, classes, module constants) and every
public member of its public classes (methods, properties, fields, class
constants) must exist in the counterpart module under ``src/repro_torch``
(``analysis/rules_pallas.py`` maps to ``analysis/rules_kernels.py``; a name
the port module imports counts), under its own name, the one ``RENAMED``
gives it or the analogue ``ANALOGUES`` names, or be listed in ``BY_DESIGN``
with the reason the port has none.  Every parameter of a public function
or method that both modules define (an analogue's excepted) must exist in
the port's, or be listed in ``PARAMS``.  Each entry of the four tables
mirrors an entry of ``ROADMAP.md`` §C ("By
design"), so a new gap shows up here as a failing test.

Also here, the values of the small members ported for the names to match:
``OocStats.tri_routes``, ``LowerBoundResult.rounds`` / ``scans`` /
``max_part_edges``, ``PartBucket.shape_key`` and ``WedgeBucket.capacity``
against the reference's on the same inputs.
"""

import ast
import re
import warnings
from pathlib import Path

import numpy as np
import pytest

ROOT = Path(__file__).resolve().parents[1]
REF, PORT = ROOT / "src" / "repro", ROOT / "src" / "repro_torch"
MODULE_MAP = {"analysis/rules_pallas.py": "analysis/rules_kernels.py"}

# (reference module, name) -> (port module, name): the same thing under
# another name or in another module
RENAMED = {
    ("analysis/rules_pallas.py", "PallasInvariantRule"):
        ("analysis/rules_kernels.py", "KernelInvariantRule"),
    ("analysis/config.py", "CheckConfig.vmem_budget_pattern"):
        ("analysis/config.py", "CheckConfig.smem_budget_pattern"),
    ("analysis/config.py", "CheckConfig.vmem_helper_pattern"):
        ("analysis/config.py", "CheckConfig.smem_helper_pattern"),
    ("core/support.py", "edge_support_jax"):
        ("core/support.py", "edge_support"),
    ("kernels/frontier_peel/ref.py", "fused_round_ref"):
        ("kernels/frontier_peel/ref.py", "fused_round"),
    ("kernels/frontier_peel/ref.py", "peel_classes_ref"):
        ("kernels/frontier_peel/ref.py", "peel_classes"),
    ("launch/dryrun.py", "COLLECTIVE_OPS"):
        ("launch/hlo_analysis.py", "COLLECTIVE_OPS"),
    ("launch/dryrun.py", "ICI_BW"): ("launch/dryrun.py", "LINK_BW"),
    ("launch/report.py", "ICI_BW"): ("launch/dryrun.py", "LINK_BW"),
    ("launch/report.py", "HBM_BW"): ("launch/dryrun.py", "HBM_BW"),
    ("launch/report.py", "PEAK_FLOPS"): ("launch/dryrun.py", "PEAK_FLOPS"),
}
# (reference module, name) -> (port module, name): the port's analogue,
# whose parameters are its own (the TPU's VMEM terms have no counterpart)
ANALOGUES = {}
for _k in ("embedding_bag", "flash_attention", "frontier_peel",
           "triangle_count"):
    ANALOGUES[(f"kernels/{_k}/kernel.py", "kernel_vmem_bytes")] = (
        f"kernels/{_k}/kernel.py", "smem_bytes")
    ANALOGUES[(f"kernels/{_k}/kernel.py", "VMEM_BUDGET_BYTES")] = (
        "kernels/build.py", "SMEM_BUDGET_BYTES")

_PALLAS_BODY = ("the Pallas kernel body: the port's kernel is CUDA C++ in "
                "csrc/, built by kernels/build.py and bound by ctypes")
_TILES = ("the TPU tile search: the port's kernels fix their own tiles "
          "(B1 one cooperative launch a round, B2 128 x 128 int8 wgmma "
          "tiles)")
_HLO = ("HLO text parsing: the port's analyze counts the dispatched torch "
        "ops (a TorchDispatchMode) and has no HLO")

# (reference module, name) -> why the port has no counterpart
BY_DESIGN = {
    ("analysis/config.py", "CheckConfig.known_donating_callables"):
        "torch has no buffer donation; TRK101 takes consuming_methods and "
        "write_through_bindings",
    ("core/peel.py", "peel_classes_fixedcap"):
        "the XLA peel chain: kernel= takes only 'auto', and the frontier "
        "engine is peel_classes",
    ("core/peel.py", "peel_threshold_fixedcap"):
        "the XLA peel chain: the frontier engine is peel_threshold",
    ("kernels/embedding_bag/kernel.py", "embedding_bag_kernel"): _PALLAS_BODY,
    ("kernels/flash_attention/kernel.py", "flash_attention_kernel"):
        _PALLAS_BODY,
    ("kernels/triangle_count/kernel.py", "triangle_count_kernel"):
        _PALLAS_BODY,
    ("kernels/frontier_peel/kernel.py", "DEFAULT_TILE_CANDIDATES"): _TILES,
    ("kernels/frontier_peel/kernel.py", "autotune_tiles"): _TILES,
    ("kernels/frontier_peel/kernel.py", "feasible_tiles"): _TILES,
    ("kernels/triangle_count/kernel.py", "DEFAULT_TILE_CANDIDATES"): _TILES,
    ("kernels/triangle_count/kernel.py", "autotune_tiles"): _TILES,
    ("kernels/triangle_count/kernel.py", "feasible_tiles"): _TILES,
    ("kernels/frontier_peel/ops.py", "fused_working_set_bytes"):
        "the TPU routing rule (VMEM): B1 runs every batched peel, its lane "
        "state in shared memory or global memory by smem_bytes",
    ("kernels/frontier_peel/ops.py", "resolve_kernel"):
        "the TPU routing rule: the route is the tensor's device",
    ("kernels/frontier_peel/ops.py", "resolve_tile"): _TILES,
    ("launch/dryrun.py", "collective_bytes"): _HLO,
    ("launch/hlo_analysis.py", "Computation"): _HLO,
    ("launch/hlo_analysis.py", "Computation.name"): _HLO,
    ("launch/hlo_analysis.py", "Computation.lines"): _HLO,
    ("launch/hlo_analysis.py", "parse_computations"): _HLO,
    ("models/common.py", "split_keys"):
        "JAX keys: the port's initialisers draw from one torch.Generator in "
        "turn",
    ("models/transformer.py", "LMConfig.flash_block"):
        "B3's tile is fixed per head width by its instantiation",
}

_ROUTE = ("the wrapper's route is its tensor's device: the plain version "
          "on the CPU, the kernel on the card")
_B1 = ("B1 removes a round's whole frontier (no capacities) and reads the "
       "triangle rows directly (no incidence CSR)")

# (reference module, function, parameter) -> the port's parameter, or why
# it has none
PARAMS = {
    ("core/peel.py", "peel_classes_batched", "indptr_b"): _B1,
    ("core/peel.py", "peel_classes_batched", "tids_b"): _B1,
    ("core/distributed.py", "peel_classes_batched_sharded", "indptr_b"): _B1,
    ("core/distributed.py", "peel_classes_batched_sharded", "tids_b"): _B1,
    ("core/distributed.py", "peel_classes_batched_sharded", "cap_f"): _B1,
    ("core/distributed.py", "peel_classes_batched_sharded", "cap_t"): _B1,
    ("core/distributed.py", "peel_classes_sharded", "cap_f"): _B1,
    ("core/distributed.py", "peel_classes_sharded", "cap_t"): _B1,
    ("kernels/embedding_bag/ops.py", "embedding_bag", "interpret"): _ROUTE,
    ("kernels/embedding_bag/ops.py", "embedding_bag", "use_kernel"): _ROUTE,
    ("kernels/flash_attention/ops.py", "flash_attention", "interpret"): _ROUTE,
    ("kernels/flash_attention/ops.py", "flash_attention", "use_kernel"):
        _ROUTE,
    ("kernels/flash_attention/ops.py", "flash_attention", "bq"): _TILES,
    ("kernels/flash_attention/ops.py", "flash_attention", "bk"): _TILES,
    ("kernels/frontier_peel/kernel.py", "fused_round", "interpret"): _ROUTE,
    ("kernels/frontier_peel/kernel.py", "fused_round", "bt"): _TILES,
    ("kernels/frontier_peel/ops.py", "peel_classes_fused", "interpret"):
        _ROUTE,
    ("kernels/frontier_peel/ops.py", "peel_classes_fused", "bt"): _TILES,
    ("kernels/frontier_peel/ops.py", "peel_threshold_fused", "interpret"):
        _ROUTE,
    ("kernels/frontier_peel/ops.py", "peel_threshold_fused", "bt"): _TILES,
    ("kernels/triangle_count/ops.py", "dense_support", "interpret"): _ROUTE,
    ("kernels/triangle_count/ops.py", "dense_support", "use_kernel"): _ROUTE,
    ("kernels/triangle_count/ops.py", "dense_support", "block"): _TILES,
    ("kernels/triangle_count/ops.py", "dense_edge_support", "interpret"):
        _ROUTE,
    ("kernels/triangle_count/ops.py", "dense_edge_support", "use_kernel"):
        _ROUTE,
    ("kernels/triangle_count/ops.py", "dense_edge_support", "block"): _TILES,
    ("kernels/triangle_count/ops.py", "dense_edge_support", "dtype"):
        "B2 reads a uint8 adjacency (int8 wgmma), always",
    ("kernels/triangle_count/ops.py", "adjacency_from_edges", "dtype"):
        "B2 reads a uint8 adjacency (int8 wgmma), always",
    ("core/support.py", "edge_support_jax", "bucketed"):
        "the port scans only by buckets; the global-D scan (bucketed=False) "
        "was the seed's fallback",
    ("launch/hlo_analysis.py", "analyze", "hlo"): _HLO,
    ("launch/hlo_analysis.py", "analyze", "entry"): _HLO,
    ("models/common.py", "dense_init", "key"): "gen",
    ("models/common.py", "dense_init", "in_axis"):
        "the fan-in is shape[-2], which every caller of the reference passes",
    ("models/common.py", "dense_init", "scale"):
        "no caller of the reference passes a scale other than 1",
    ("models/common.py", "embed_init", "key"): "gen",
    ("models/gnn/layers.py", "mlp_init", "key"): "gen",
    ("models/gnn/models.py", "sage_init", "key"): "gen",
    ("models/gnn/models.py", "gat_init", "key"): "gen",
    ("models/gnn/models.py", "mgn_init", "key"): "gen",
    ("models/gnn/models.py", "eqv2_init", "key"): "gen",
    ("models/recsys/din.py", "din_init", "key"): "gen",
    ("models/transformer.py", "init_params", "key"): "gen",
    ("models/gnn/distributed.py", "ring_aggregate", "axis"): "group",
    ("models/gnn/distributed.py", "make_ring_layer", "axis"): "group",
    ("optim/compression.py", "compressed_psum", "axis"): "group",
}


def _public(name: str) -> bool:
    return not name.split(".")[-1].startswith("_")


def _surface(path: Path, with_imports: bool) -> dict:
    """{public name: parameter names (None for a non-function)} of a
    module: top-level functions, classes and assigned names, and each
    public class's methods, annotated fields and assigned attributes as
    ``Class.member``; with ``with_imports``, the names it imports too."""
    out: dict = {}

    def params(f):
        a = f.args
        names = [x.arg for x in a.posonlyargs + a.args + a.kwonlyargs]
        names += [x.arg for x in (a.vararg, a.kwarg) if x is not None]
        return [x for x in names if x not in ("self", "cls")]

    def targets(node):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                for e in (t.elts if isinstance(t, ast.Tuple) else [t]):
                    if isinstance(e, ast.Name):
                        yield e.id
        elif isinstance(node, ast.AnnAssign) and isinstance(node.target,
                                                            ast.Name):
            yield node.target.id

    for node in ast.parse(path.read_text()).body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            out[node.name] = params(node)
        elif isinstance(node, ast.ClassDef):
            out[node.name] = None
            if not _public(node.name):
                continue
            for b in node.body:
                if isinstance(b, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    out[f"{node.name}.{b.name}"] = params(b)
                for t in targets(b):
                    out[f"{node.name}.{t}"] = None
        elif isinstance(node, ast.ImportFrom) and with_imports:
            for a in node.names:
                out[a.asname or a.name] = None
        for t in targets(node):
            out[t] = None
    return {k: v for k, v in out.items() if _public(k)}


MODULES = sorted(str(p.relative_to(REF)) for p in REF.rglob("*.py"))


def _port_module(mod: str) -> str:
    return MODULE_MAP.get(mod, mod)


def _counterpart(mod: str, name: str):
    """(port module, port name) that stands for ``mod``'s ``name``."""
    for table in (RENAMED, ANALOGUES):
        if (mod, name) in table:
            return table[(mod, name)]
    cls, _, member = name.partition(".")
    if member and (mod, cls) in RENAMED:
        pmod, pcls = RENAMED[(mod, cls)]
        return pmod, f"{pcls}.{member}"
    return _port_module(mod), name


def test_every_reference_module_has_a_counterpart_file():
    assert len(MODULES) == 77
    missing = [m for m in MODULES if not (PORT / _port_module(m)).exists()]
    assert not missing, missing


@pytest.mark.parametrize("mod", MODULES)
def test_every_public_name_has_a_counterpart(mod):
    missing = []
    for name in _surface(REF / mod, with_imports=False):
        if (mod, name) in BY_DESIGN:
            continue
        pmod, pname = _counterpart(mod, name)
        if pname not in _surface(PORT / pmod, with_imports=True):
            missing.append(f"{name} (looked for {pmod}::{pname})")
    assert not missing, (f"src/repro/{mod}: no counterpart in src/repro_torch "
                         f"and not listed in BY_DESIGN: {missing}")


@pytest.mark.parametrize("mod", MODULES)
def test_every_parameter_has_a_counterpart(mod):
    ref = _surface(REF / mod, with_imports=False)
    missing = []
    for name, params in ref.items():
        if params is None or (mod, name) in BY_DESIGN \
                or (mod, name) in ANALOGUES:
            continue
        pmod, pname = _counterpart(mod, name)
        got = _surface(PORT / pmod, with_imports=True).get(pname)
        if got is None:
            continue            # a re-export: its own module is walked
        for p in params:
            why = PARAMS.get((mod, name, p))
            if p in got or why is not None and why in got:
                continue
            if why is None:
                missing.append(f"{name}({p})")
    assert not missing, (f"src/repro/{mod}: parameters with no counterpart "
                         f"and not listed in PARAMS: {missing}")


def test_tables_name_only_live_gaps():
    """Every table entry names a reference member that exists and a gap
    that is still open: a by-design name the port has since gained, or a
    rename whose target went away, fails here."""
    for (mod, name), (pmod, pname) in (*RENAMED.items(),
                                       *ANALOGUES.items()):
        assert name in _surface(REF / mod, False), (mod, name)
        assert pname in _surface(PORT / pmod, True), (pmod, pname)
        assert name.split(".")[-1] != pname.split(".")[-1] or mod != pmod
    for mod, name in BY_DESIGN:
        assert name in _surface(REF / mod, False), (mod, name)
        assert name not in _surface(PORT / _port_module(mod), True), (
            mod, name)
    for (mod, fn, p), why in PARAMS.items():
        ref = _surface(REF / mod, False)[fn]
        port = _surface(PORT / _counterpart(mod, fn)[0], True)[
            _counterpart(mod, fn)[1]]
        assert p in ref and p not in port, (mod, fn, p)
        assert " " in why or why in port, (mod, fn, p, why)


def _roadmap_by_design() -> str:
    text = (ROOT / "ROADMAP.md").read_text()
    sec = text[text.index("### C."):text.index("## Recent")]
    return sec[sec.index("By design"):]


@pytest.mark.parametrize("table", ["RENAMED", "ANALOGUES", "BY_DESIGN",
                                   "PARAMS"])
def test_tables_mirror_roadmap(table):
    """Each entry's reference name (``Class.member`` for a member; a
    parameter and its function) is written in ROADMAP.md §C's by-design
    list."""
    sec = _roadmap_by_design()
    tokens = set(re.findall(r"`([^`]+)`", sec))
    entries = {"RENAMED": RENAMED, "ANALOGUES": ANALOGUES,
               "BY_DESIGN": BY_DESIGN, "PARAMS": PARAMS}[table]
    missing = []
    for key in entries:
        names = [key[1]] if table != "PARAMS" else [key[1], key[2]]
        missing += [n for n in names if n not in tokens]
    assert not missing, f"{table}: not in ROADMAP.md §C: {sorted(set(missing))}"


# --- the members ported for the surface to match ----------------------------

def _corpus(name):
    from tests.conftest import conformance_corpus

    return [(n, e) for nm, n, e in conformance_corpus() if nm == name][0]


@pytest.mark.parametrize("name", ["rmat", "clustered", "er"])
def test_tri_routes_and_lower_bound_counters(name):
    """``OocStats.tri_routes`` equals ``ns_sweeps`` and the reference's on a
    bottom-up run; ``LowerBoundResult``'s rounds, scans and
    ``max_part_edges`` equal its stats' and the reference's fields."""
    from repro.core import bottom_up as jbu
    from repro_torch.core import bottom_up as tbu

    n, edges = _corpus(name)
    budget = max(12, len(edges) // 4)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        j = jbu.bottom_up_decompose(n, edges, budget)
        t = tbu.bottom_up_decompose(n, edges, budget, device="cpu")
        jl = jbu.lower_bounding(n, edges, budget)
        tl = tbu.lower_bounding(n, edges, budget, device="cpu")
    np.testing.assert_array_equal(t.phi, j.phi)
    assert t.stats.tri_routes == t.stats.ns_sweeps > 0
    assert t.stats.tri_routes == j.stats.tri_routes
    assert (tl.rounds, tl.scans, tl.max_part_edges) == (
        tl.stats.rounds, tl.stats.scans, tl.stats.max_part_edges)
    assert (tl.rounds, tl.scans, tl.max_part_edges) == (
        jl.rounds, jl.scans, jl.max_part_edges)
    assert tl.stats.tri_routes == jl.stats.tri_routes


@pytest.mark.parametrize("name", ["rmat", "clustered", "disconnected"])
def test_shape_key_is_the_noted_launch_shape(name):
    """``PartBucket.shape_key`` is the key ``peel_classes_batched`` notes
    for the bucket on one device (a triangle-free bucket peels on the host
    and notes none), and the reference's key has the same lanes and
    capacities."""
    from repro.core import graph as jgraph
    from repro.core import partition as jpart
    from repro_torch.core import graph as tgraph
    from repro_torch.core import partition as tpart
    from repro_torch.core import peel as tpeel

    n, edges = _corpus(name)
    tg, jg = tgraph.build_graph(n, edges), jgraph.build_graph(n, edges)
    budget = max(16, tg.m // 3)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        tb = tpart.build_partition_batch(
            tg, tpart.sequential_partition(tg, budget))
        jb = jpart.build_partition_batch(
            jg, jpart.sequential_partition(jg, budget))
    cache, launched = set(), set()
    for b in tb.buckets:
        tpeel.peel_classes_batched(b.sup, b.tris, b.alive, shape_cache=cache,
                                   device="cpu")
        if (b.tris[:, :, 0] < b.cap_e).any():
            launched.add(b.shape_key)
    assert launched and cache == launched
    assert [(b.shape_key[0][0], b.shape_key[0][1], b.shape_key[1][1])
            for b in tb.buckets] == [b.shape_key for b in jb.buckets]


@pytest.mark.parametrize("name", ["rmat", "star-hub", "er"])
def test_wedge_bucket_capacity_matches_reference(name):
    from repro.core import graph as jgraph
    from repro.core import support as jsup
    from repro_torch.core import graph as tgraph
    from repro_torch.core import support as tsup

    n, edges = _corpus(name)
    tp = tsup.wedge_bucket_plan(tgraph.build_graph(n, edges))
    jp = jsup.wedge_bucket_plan(jgraph.build_graph(n, edges))
    assert [b.capacity for b in tp] == [b.capacity for b in jp]
    assert all(b.capacity == len(b.eids) * b.D for b in tp)
