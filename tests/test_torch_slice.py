"""The first slice of the PyTorch port end to end, against ``repro``.

``truss_decompose`` (in-memory engines, bottom-up with both partitioners,
``memory_budget`` routing) and unbudgeted ``top_down_decompose`` must give
the JAX package's phi on the conformance corpus and an R-MAT graph, with
the ``OocStats`` counters that both packages define the same way equal.
The port runs on the CPU here (``device="cpu"``); comparisons are exact.
Also pinned: the port imports neither ``jax`` nor ``repro``, its default
device is the CUDA card, and not-yet-ported arguments and configs raise.
"""

import ast
import io
import subprocess
import sys
import warnings
from contextlib import redirect_stdout
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.core import bottom_up as jbu
from repro.core import graph as jgraph
from repro.core import peel as jpeel
from repro.core import top_down as jtd
from repro.core.partition import PartitionBudgetWarning
from repro.data import graphgen as jgen
from repro_torch.core import bottom_up as tbu
from repro_torch.core import peel as tpeel
from repro_torch.core import serial as tserial
from repro_torch.core import top_down as ttd
from repro_torch.core.partition import \
    PartitionBudgetWarning as TPartitionBudgetWarning
from tests.conftest import conformance_corpus

torch.manual_seed(0)

REPO = Path(__file__).resolve().parents[1]


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = jgen.rmat(9, 6, seed=1)
    out.append(("rmat9", n, e))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]
OOC_FIELDS = ("rounds", "scans", "batches", "parts", "tri_total",
              "tri_assigned", "overlapped", "stage2_overlapped")


def _quiet(fn, *args, **kw):
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PartitionBudgetWarning)
        warnings.simplefilter("ignore", TPartitionBudgetWarning)
        return fn(*args, **kw)


def _budget(n, edges):
    """A budget that gives several partition rounds on every graph."""
    return jpeel.estimate_working_set(jgraph.build_graph(n, edges)) // 4


CONFIGS = {
    "auto": dict(),
    "frontier": dict(engine="frontier"),
    "dense": dict(engine="dense"),
    "bottom-up-sequential": dict(engine="bottom-up", budget=True),
    "bottom-up-random": dict(engine="bottom-up", partitioner="random",
                             partitioner_seed=3, budget=True),
    "memory-budget-routing": dict(budget=True),
}


def _kwargs(cfg, n, edges):
    kw = dict(CONFIGS[cfg])
    if kw.pop("budget", False):
        kw["memory_budget"] = _budget(n, edges)
    return kw


@pytest.mark.parametrize("cfg", list(CONFIGS))
@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_truss_decompose_equal(name, n, edges, cfg):
    kw = _kwargs(cfg, n, edges)
    if cfg == "auto":
        # no stats: "auto" then picks the engine by triangle density
        want = jpeel.truss_decompose(n, edges, **kw)
        got = tpeel.truss_decompose(n, edges, device="cpu", **kw)
        assert got.dtype == np.int64
        np.testing.assert_array_equal(got, want)
        return
    want, jst = _quiet(jpeel.truss_decompose, n, edges, with_stats=True, **kw)
    got, tst = _quiet(tpeel.truss_decompose, n, edges, with_stats=True,
                      device="cpu", **kw)
    assert got.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    if isinstance(jst, jbu.OocStats):
        assert isinstance(tst, tbu.OocStats), cfg
        for f in OOC_FIELDS:
            assert getattr(tst, f) == getattr(jst, f), (name, cfg, f)
        assert tst.rounds >= 1
    elif jst is not None:                    # in-memory frontier PeelStats
        assert tst == tpeel.PeelStats(**vars(jst)), (name, cfg)
    else:
        assert tst is None


@pytest.mark.parametrize("kind", ["sequential", "random"])
@pytest.mark.parametrize("name,n,edges", GRAPHS[-3:], ids=IDS[-3:])
def test_bottom_up_candidate_sizes_equal(name, n, edges, kind):
    # the part budget truss_decompose derives from _budget, so both
    # packages see the launch shapes of test_truss_decompose_equal again
    m = len(edges)
    est = jpeel.estimate_working_set(jgraph.build_graph(n, edges))
    budget = max(64, (2 * m * _budget(n, edges)) // max(est, 1))
    j = _quiet(jbu.bottom_up_decompose, n, edges, budget, partitioner=kind)
    t = _quiet(tbu.bottom_up_decompose, n, edges, budget, partitioner=kind,
               device="cpu")
    np.testing.assert_array_equal(t.phi, j.phi)
    assert t.candidate_sizes == j.candidate_sizes
    assert (t.kmax, t.rounds, t.scans) == (j.kmax, j.rounds, j.scans)
    for f in OOC_FIELDS:
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)


# every graph with all classes; top-t and the literal Procedure 8 on the
# graphs with several classes
TOP_DOWN_CASES = ([(g, "all", {}) for g in GRAPHS]
                  + [(g, "t2", dict(t=2)) for g in GRAPHS[:2] + GRAPHS[-1:]]
                  + [(g, "faithful", dict(faithful_proc8=True))
                     for g in GRAPHS[:2] + GRAPHS[-1:]])


@pytest.mark.parametrize("name,n,edges,kw",
                         [(*g, kw) for g, _, kw in TOP_DOWN_CASES],
                         ids=[f"{g[0]}-{i}" for g, i, _ in TOP_DOWN_CASES])
def test_top_down_equal(name, n, edges, kw):
    j = jtd.top_down_decompose(n, edges, **kw)
    t = ttd.top_down_decompose(n, edges, device="cpu", **kw)
    np.testing.assert_array_equal(t.phi, j.phi)
    assert (t.classes, t.kmax, t.candidate_sizes, t.pruned) == \
        (j.classes, j.kmax, j.candidate_sizes, j.pruned)
    for f in ("scans", "batches", "stage2_overlapped"):
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)


def test_top_down_dense_core_equal():
    """A dense core (edge density >= 1/8): top-down's supports take the
    dense-support kernel's plain version."""
    n, edges = 120, jgen.erdos_renyi(120, 2000, seed=5)
    j = jtd.top_down_decompose(n, edges)
    t = ttd.top_down_decompose(n, edges, device="cpu")
    np.testing.assert_array_equal(t.phi, j.phi)
    np.testing.assert_array_equal(t.phi, tserial.alg2_truss(n, edges))


def test_kmax_truss_equal():
    name, n, edges = GRAPHS[-1]
    (jk, je), (tk, te) = jpeel.kmax_truss(n, edges), \
        tpeel.kmax_truss(n, edges, device="cpu")
    assert jk == tk
    np.testing.assert_array_equal(te, je)


def test_serial_oracle_copy_equal():
    from repro.core import serial as jserial

    for name, n, edges in GRAPHS:
        phi = tserial.alg2_truss(n, edges)
        np.testing.assert_array_equal(phi, jserial.alg2_truss(n, edges))
        assert tserial.verify_truss(n, edges, phi)
        if phi.max() > 2:
            bad = phi.copy()
            bad[np.argmax(phi)] += 1
            assert not tserial.verify_truss(n, edges, bad)


# -- the paper's Figure-2 graph, as examples/quickstart.py runs it ----------

NAMES = {c: i for i, c in enumerate("abcdefghijkl")}
FIG2 = """a b;a c;a d;a e;b c;b d;b e;c d;c e;d e;d g;d k;d l;e f;e g;f g;
g h;g k;g l;f h;f i;f j;h i;h j;i j;i k"""


def _quickstart(truss_decompose, bottom_up_decompose, top_down_decompose,
                canonical_edges, **dev):
    """examples/quickstart.py, parameterized by package."""
    edges = np.array([[NAMES[x] for x in p.split()]
                      for p in FIG2.replace("\n", "").split(";") if p.strip()])
    n = 12
    ce = canonical_edges(edges, n)
    inv = {v: k for k, v in NAMES.items()}
    phi = truss_decompose(n, ce, **dev)
    print("k-classes of the Figure-2 graph:")
    for k in sorted(set(phi.tolist())):
        cls = [f"({inv[u]},{inv[v]})" for (u, v), p in zip(ce, phi) if p == k]
        print(f"  Phi_{k}: {' '.join(cls)}")
    print(f"  k_max = {phi.max()}  (the 5-truss is the clique a-e)")
    bu = bottom_up_decompose(n, ce, budget=10, **dev)
    td = top_down_decompose(n, ce, **dev)
    assert (bu.phi == phi).all() and (td.phi == phi).all()
    print("bottom-up (budget=10 edges) and top-down agree. "
          f"bottom-up used {bu.rounds} partition rounds, {bu.scans} scans.")


def test_quickstart_port_prints_same_classes():
    outs = []
    for args, dev in (((jpeel.truss_decompose, jbu.bottom_up_decompose,
                        jtd.top_down_decompose, jgraph.canonical_edges), {}),
                      ((tpeel.truss_decompose, tbu.bottom_up_decompose,
                        ttd.top_down_decompose,
                        __import__("repro_torch.core.graph",
                                   fromlist=["x"]).canonical_edges),
                       dict(device="cpu"))):
        buf = io.StringIO()
        with redirect_stdout(buf):
            _quiet(_quickstart, *args, **dev)
        outs.append(buf.getvalue())
    assert outs[0] == outs[1]
    assert "Phi_5: (a,b) (a,c) (a,d) (a,e) (b,c)" in outs[1]
    for k in (2, 3, 4, 5):
        assert f"Phi_{k}:" in outs[1]


# -- import hygiene and device / argument contracts -------------------------

def test_port_runs_with_jax_blocked():
    code = (
        "import sys; sys.modules['jax'] = None; sys.modules['repro'] = None\n"
        "sys.modules['ml_dtypes'] = None\n"
        "import numpy as np\n"
        "from repro_torch.core.peel import truss_decompose\n"
        "from repro_torch.core import bottom_up, top_down, serial, faults\n"
        "from repro_torch.checkpoint import manager\n"
        "from repro_torch import interop\n"
        "import repro_torch.kernels.frontier_peel.kernel\n"
        "import repro_torch.kernels.triangle_count.ops\n"
        "import repro_torch.kernels.embedding_bag.ops\n"
        "import dataclasses, torch\n"
        "from repro_torch.configs import registry\n"
        "from repro_torch.configs.reduced import reduced_lm\n"
        "from repro_torch.launch import serve\n"
        "from repro_torch.models import transformer as T\n"
        "e = np.array([[0,1],[0,2],[1,2],[2,3],[1,3],[0,3],[3,4]])\n"
        "phi = truss_decompose(5, e, device='cpu')\n"
        "assert (phi == serial.alg2_truss(5, e)).all(), phi\n"
        "import tempfile\n"
        "with tempfile.TemporaryDirectory() as d:\n"
        "    td = top_down.top_down_decompose(5, e, budget=64, device='cpu',"
        " checkpoint_dir=d)\n"
        "    assert (td.phi == phi).all() and manager.latest_step(d)\n"
        "    from repro_torch.core.store import ChunkedDiskStore\n"
        "    with ChunkedDiskStore(d + '/store', chunk_bytes=64) as st:\n"
        "        bu = bottom_up.bottom_up_decompose(5, e, 64, device='cpu',"
        " partitioner='locality', store=st)\n"
        "    assert (bu.phi == phi).all() and bu.stats.chunk_writes > 0\n"
        "cfg = dataclasses.replace(reduced_lm(registry.get_config("
        "'gemma3-4b')), use_flash_kernel=True, window=8)\n"
        "p = T.init_params(torch.Generator().manual_seed(0), cfg)\n"
        "toks = np.arange(2 * 80).reshape(2, 80) % cfg.vocab\n"
        "cache, last = T.prefill(p, toks, cfg, max_seq=84, device='cpu')\n"
        "assert last.shape == (2, cfg.vocab) and bool(last.isfinite().all())\n"
        "print('ok', phi.tolist())\n")
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120,
                         env={"PYTHONPATH": str(REPO / "src"),
                              "PATH": "/usr/bin:/bin"})
    assert res.returncode == 0, res.stderr
    assert res.stdout.startswith("ok [4, 4, 4, 4, 4, 4, 2]")


def test_port_sources_import_neither_jax_nor_repro():
    files = sorted((REPO / "src" / "repro_torch").rglob("*.py"))
    assert len(files) > 10
    for path in files:
        tree = ast.parse(path.read_text(), filename=str(path))
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom):
                names = [node.module or ""]
            else:
                continue
            for name in names:
                root = name.split(".")[0]
                assert root not in ("jax", "jaxlib", "repro"), (path, name)


def test_default_device_needs_cuda(monkeypatch):
    from repro_torch.configs import registry
    from repro_torch.configs.reduced import reduced_lm
    from repro_torch.launch import serve
    from repro_torch.models import transformer as T

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    e = np.array([[0, 1], [1, 2], [0, 2]])
    cfg = reduced_lm(registry.get_config("gemma3-4b"))
    params = T.init_params(torch.Generator().manual_seed(0), cfg)
    toks = np.zeros((1, 4), np.int32)
    for call in (lambda: tpeel.truss_decompose(3, e),
                 lambda: tpeel.kmax_truss(3, e),
                 lambda: tbu.bottom_up_decompose(3, e, 64),
                 lambda: ttd.top_down_decompose(3, e),
                 lambda: tpeel.truss_decompose(3, e, device="cuda"),
                 lambda: T.prefill(params, toks, cfg),
                 lambda: T.forward(params, toks, cfg),
                 lambda: serve.generate(params, toks, cfg, 2, 6),
                 lambda: serve.main(["--new-tokens", "1"])):
        with pytest.raises(RuntimeError, match="CUDA"):
            call()


@pytest.mark.parametrize("kw", [
    dict(mesh=object()), dict(mesh_axes=("data",)),
    dict(checkpoint_dir="ckpt"), dict(resume=True), dict(store=object()),
    dict(host_memory_budget=1 << 20), dict(edits=[("+", 0, 3)]),
    dict(phi0=np.zeros(3)), dict(partitioner="locality", engine="bottom-up"),
    dict(engine="top-down")])
def test_unported_arguments_raise(kw, tmp_path):
    """Every argument once unported now does what the reference does with
    the same call: on the in-memory route ``checkpoint_dir``, ``store`` and
    ``host_memory_budget`` warn and are ignored, and ``resume``, ``mesh``
    and ``mesh_axes`` are ignored; ``engine="top-down"`` and
    ``partitioner="locality"`` give the reference's phi; an edit with an
    unknown op, and ``phi0`` without ``edits``, raise ``ValueError``
    (maintenance)."""
    e = np.array([[0, 1], [1, 2], [0, 2]])
    want = jpeel.truss_decompose(3, e, **{
        k: v for k, v in kw.items() if k in ("engine", "partitioner")})
    if "checkpoint_dir" in kw:
        with pytest.warns(UserWarning, match="in-memory"):
            got = tpeel.truss_decompose(3, e, device="cpu",
                                        checkpoint_dir=str(tmp_path))
        assert not list(tmp_path.iterdir())
    elif "store" in kw or "host_memory_budget" in kw:
        with pytest.warns(UserWarning, match="in-memory"):
            jpeel.truss_decompose(3, e, **kw)
        with pytest.warns(UserWarning, match="in-memory"):
            got = tpeel.truss_decompose(3, e, device="cpu", **kw)
    elif "edits" in kw or "phi0" in kw:
        with pytest.raises(ValueError):
            jpeel.truss_decompose(3, e, **kw)
        with pytest.raises(ValueError, match="phi0|insert.*delete"):
            tpeel.truss_decompose(3, e, device="cpu", **kw)
        return
    else:
        # resume, engine="top-down", partitioner, and the mesh arguments,
        # which the in-memory route ignores (as the reference does)
        assert jpeel.truss_decompose(3, e, **kw).tolist() == want.tolist()
        got = tpeel.truss_decompose(3, e, device="cpu", **kw)
    np.testing.assert_array_equal(got, want)


def test_invalid_arguments_rejected(tmp_path):
    e = np.array([[0, 1], [1, 2], [0, 2]])
    with pytest.raises(ValueError):
        tpeel.truss_decompose(3, e, kernel="pallas", device="cpu")
    with pytest.raises(ValueError):
        tpeel.truss_decompose(3, e, memory_budget=0, device="cpu")
    with pytest.raises(ValueError):
        tpeel.truss_decompose(3, e, engine="bogus", device="cpu")
    with pytest.raises(ValueError):
        tbu.bottom_up_decompose(3, e, 64, partitioner="bogus", device="cpu")
    # budget=, checkpoint_dir= and store= are ported: a budgeted top-down
    # gives the reference's phi, bottom-up journals, a store run gives the
    # reference's phi, and a store without a budget is refused
    np.testing.assert_array_equal(
        ttd.top_down_decompose(3, e, budget=64, device="cpu").phi,
        jtd.top_down_decompose(3, e, budget=64).phi)
    res = tbu.bottom_up_decompose(3, e, 64, device="cpu",
                                  checkpoint_dir=str(tmp_path))
    assert res.stats.checkpoints > 0 and list(tmp_path.iterdir())
    from repro.core.store import InMemoryStore as JInMemoryStore
    from repro_torch.core.store import InMemoryStore

    with InMemoryStore() as store, JInMemoryStore() as jstore:
        np.testing.assert_array_equal(
            tbu.bottom_up_decompose(3, e, 64, device="cpu", store=store).phi,
            jbu.bottom_up_decompose(3, e, 64, store=jstore).phi)
    with InMemoryStore() as store, JInMemoryStore() as jstore:
        np.testing.assert_array_equal(
            ttd.top_down_decompose(3, e, budget=64, device="cpu",
                                   store=store).phi,
            jtd.top_down_decompose(3, e, budget=64, store=jstore).phi)
    with InMemoryStore() as store:
        with pytest.raises(ValueError, match="budget"):
            ttd.top_down_decompose(3, e, budget=None, device="cpu",
                                   store=store)
    # a mesh (a one-rank gloo mesh in this process) with a journal: the
    # reference's phi, and the journal written
    from tests.torch_mesh import one_rank_mesh

    with one_rank_mesh(tmp_path) as mesh:
        for fn, jfn in ((tbu.bottom_up_decompose, jbu.bottom_up_decompose),
                        (ttd.top_down_decompose, jtd.top_down_decompose)):
            ckpt_dir = tmp_path / fn.__name__
            res = fn(3, e, 64, device="cpu", checkpoint_dir=str(ckpt_dir),
                     mesh=mesh)
            np.testing.assert_array_equal(res.phi, jfn(3, e, 64).phi)
            assert res.stats.checkpoints > 0 and list(ckpt_dir.iterdir())
    assert len(tpeel.truss_decompose(3, np.zeros((0, 2)), device="cpu")) == 0
