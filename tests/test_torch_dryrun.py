"""The port's dry-run layer (``launch/hlo_analysis.py``, ``dryrun.py``,
``mesh.py``, ``report.py``) against the JAX package's.

``hlo_analysis.analyze`` counts the reduced gemma3-4b forward loss (2 x 64
tokens) eagerly; the reference walks the HLO of the same jitted loss.  Both
count the same matmuls, so the flops and the dot bytes are held equal
(tolerance 0; the ratio is printed).  ``run_cell`` traces four cells on a
fake (4, 2) ("data", "model") group: each record is ``ok`` with a positive
memory term, and its ``arg_bytes`` equal rank 0's shards counted by hand;
``report.render`` gives the reference's text for the same records.  (The
ring's collectives on four ranks are counted in ``test_torch_ring.py``.)
Every fake group is destroyed in a ``finally``.
"""

import json
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import reduced as jreduced
from repro.configs import registry as jregistry
from repro.launch import hlo_analysis as jha
from repro.launch import report as jreport
from repro.models import transformer as JT
from repro_torch import interop, tree
from repro_torch.configs import reduced, registry
from repro_torch.configs.cells import NamedSharding
from repro_torch.launch import dryrun, hlo_analysis, mesh as tmesh, report
from repro_torch.models import transformer as T

CELLS = ["gat-cora×full_graph_sm", "din×serve_p99",
         "graphsage-reddit×ogb_products", "gemma3-4b×decode_32k"]


def test_analyze_counts_the_reference_flops(capsys):
    jcfg = jreduced.reduced_lm(jregistry.get_config("gemma3-4b"))
    cfg = reduced.reduced_lm(registry.get_config("gemma3-4b"))
    params = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tok = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 64)).astype(
        np.int32)
    batch = {"tokens": tok, "labels": np.roll(tok, -1, 1).copy()}
    hlo = jax.jit(lambda p, b: JT.loss_fn(p, b, jcfg)[0]).lower(
        params, {k: jnp.asarray(v) for k, v in batch.items()}).compile(
    ).as_text()
    want = jha.analyze(hlo)
    tp = interop.lm_params(jax.tree.map(np.asarray, params), device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        got = hlo_analysis.analyze(lambda: T.loss_fn(tp, tb, cfg,
                                                      device="cpu"))
    print(f"analyze flops port / reference: {got['flops'] / want['flops']}")
    assert want["flops"] == 153_403_392
    assert got["flops"] == want["flops"]
    assert got["dot_bytes"] == want["dot_bytes"]
    assert set(got["collective_bytes"]) == set(jha.COLLECTIVE_OPS)
    assert sum(got["collective_counts"].values()) == 0


def test_counter_tracks_the_peak_of_live_bytes():
    def f(x):
        a = x * 2
        b = a + 1
        del a
        c = b.view(-1).sum()
        d = torch.zeros(2 * x.numel(), device=x.device)
        return c, d

    for dev in ("cpu", "meta"):
        with hlo_analysis.Counter() as c:
            out = f(torch.ones(1000, device=dev))
        assert c.peak_bytes == 4000 + 4000 + 8000 + 4
        del out


@pytest.fixture(scope="module")
def records():
    from torch.distributed.device_mesh import init_device_mesh

    recs, hand = [], []
    with dryrun.fake_group(8):
        mesh = init_device_mesh("cpu", (4, 2), mesh_dim_names=("data",
                                                               "model"))
        for key in CELLS:
            cell = registry.get_cell(*key.split("×"))
            recs.append(dryrun.run_cell(cell, mesh, "4x2"))
            hand.append(_hand_arg_bytes(cell, mesh))
    assert not dist.is_initialized()
    return recs, hand


def _hand_arg_bytes(cell, mesh) -> int:
    """Rank 0's bytes of a cell's inputs: each leaf's shape cut to the
    first chunk along each mesh axis its resolved spec names, in mesh
    order (a None sharding: replicated)."""
    _, args, in_sh = cell.build(mesh)[:3]
    sizes = dict(zip(mesh.mesh_dim_names, mesh.shape))
    total = 0

    def leaf(t, spec):
        shape = list(t.shape)
        for axis in mesh.mesh_dim_names:
            for d, e in enumerate(spec):
                if e == axis or (isinstance(e, tuple) and axis in e):
                    shape[d] = -(-shape[d] // sizes[axis])
        return math.prod(shape) * t.element_size()

    def walk(a, s):
        nonlocal total
        if s is None or isinstance(s, NamedSharding):
            spec = () if s is None else s.spec
            total += sum(leaf(t, spec) for t in tree.leaves(a))
        elif isinstance(a, dict):
            for k in a:
                walk(a[k], s[k])
        else:
            for x, y in zip(a, s):
                walk(x, y)

    walk(args, in_sh)
    return total


@pytest.mark.parametrize("i", range(len(CELLS)))
def test_run_cell_records(records, i):
    rec, hand = records[0][i], records[1][i]
    assert rec["ok"], rec.get("traceback")
    assert rec["t_memory"] > 0 and rec["t_compute"] > 0
    assert rec["arg_bytes"] == hand
    assert rec["n_devices"] == 8 and rec["mesh"] == "4x2"
    assert rec["bottleneck"] in ("compute", "memory", "collective")
    for k in ("lower_s", "compile_s"):
        assert k not in rec
    assert rec["trace_s"] >= 0 and rec["temp_bytes"] > 0


def test_ring_cell_records_the_permutes(records):
    rec = records[0][CELLS.index("graphsage-reddit×ogb_products")]
    counts = rec["collectives"]["counts"]
    # forward: 2 layers x (P + 1); backward: the second layer's ring, P
    assert counts["collective-permute"] == 2 * 9 + 8
    assert counts["all-to-all"] == 0


def test_report_renders_the_reference_text(records):
    recs = [dict(r) for r in records[0]]
    recs.append({"arch": "x", "shape": "y", "kind": "train", "ok": False,
                 "error": "ValueError: " + "e" * 80})
    assert report.render(recs, "Mesh 4x2") == jreport.render(recs,
                                                              "Mesh 4x2")
    json.dumps(recs)


def test_dryrun_cli_writes_its_records(tmp_path, capsys):
    out = tmp_path / "dry.json"
    recs = dryrun.main(["--arch", "gat-cora", "--shape", "molecule",
                        "--out", str(out)])
    assert not dist.is_initialized()
    assert json.loads(out.read_text()) == json.loads(json.dumps(recs))
    assert [r["ok"] for r in recs] == [True]
    assert recs[0]["mesh"] == "pod16x16" and recs[0]["n_devices"] == 256
    assert "1/1 cells traced" in capsys.readouterr().out


def test_fake_group_is_destroyed_on_error():
    with pytest.raises(RuntimeError):
        with dryrun.fake_group(4):
            assert dist.get_world_size() == 4
            raise RuntimeError("boom")
    assert not dist.is_initialized()


@pytest.mark.parametrize("world,shape", [(8, (2, 4)), (4, (2, 2)),
                                         (16, (4, 4)), (2, (2, 1))])
def test_host_mesh_factors_as_the_reference(world, shape):
    with dryrun.fake_group(world):
        m = tmesh.make_host_mesh()
        assert tuple(m.shape) == shape
        assert m.mesh_dim_names == ("data", "model")
    with pytest.raises(ValueError):
        tmesh.make_host_mesh(0)
