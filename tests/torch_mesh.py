"""Gloo ranks for the mesh tests of the PyTorch port (not a test module).

:func:`spawn` starts one process per rank of a CPU ``DeviceMesh`` of the
given shape (axes ``("data",)`` or ``("data", "tri")``).  Each runs this
file as a script: it blocks ``jax`` and ``repro`` (a rank imports only
``repro_torch``), uses one thread, meets the others through a rendezvous
file, runs one of the ``SUITES`` on the pickled payload and pickles its
result.  A rank that does not finish within the timeout is killed with
the others, and the spawn fails.  :func:`one_rank_mesh` is a one-rank
gloo group and its mesh in the calling process.

``JAX_MESH_SCRIPT`` runs the JAX package's drivers on forced host devices
(``XLA_FLAGS=--xla_force_host_platform_device_count=4``) and prints their
phi and counters as JSON, for the tests to hold the port's mesh runs
against.
"""

from __future__ import annotations

import contextlib
import json
import os
import pickle
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
AXES = ("data", "tri")
# the OocStats counters both packages define alike (compiles is keyed on
# each package's launch shapes, and the *_s timers are the host's)
STATS = ("devices", "sharded_rounds", "rounds", "scans", "batches", "parts",
         "real_edges", "padded_slots", "tri_total", "tri_assigned",
         "overlapped", "stage2_overlapped", "retries", "degraded",
         "edits_applied", "maintain_levels", "affected_edges")
# injected OOMs that exhaust a ladder's retries: the stage-1 dispatch and
# both its lane splits, or a top-down level three times (max_retries = 2)
MESH_DROP_PLANS = {
    "bottom-up": dict(site="dispatch", where={"stage": 1}, times=3),
    "top-down": dict(site="dispatch", where={"stage": "td"}, times=3),
}


def mesh_axis(shape) -> object:
    """The drivers' ``mesh_axis`` for a mesh shape: the lane axis alone, or
    the (lane, tri) pair."""
    return AXES[0] if len(shape) == 1 else AXES[:len(shape)]


def spawn(suite: str, shape, payload, tmp, timeout: float = 300.0) -> list:
    """Run ``SUITES[suite]`` on every rank of a mesh of ``shape``; returns
    the ranks' results in rank order."""
    tmp = Path(tmp)
    tmp.mkdir(parents=True, exist_ok=True)
    with open(tmp / "payload.pkl", "wb") as f:
        pickle.dump(payload, f)
    world = 1
    for s in shape:
        world *= s
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               OMP_NUM_THREADS="1")
    shape_arg = ",".join(str(s) for s in shape)
    procs = [subprocess.Popen(
        [sys.executable, __file__, suite, str(tmp / "rendezvous"), str(r),
         shape_arg, str(tmp / "payload.pkl"), str(tmp / f"rank{r}.pkl")],
        env=env, cwd=str(ROOT), stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for r in range(world)]
    deadline = time.monotonic() + timeout
    logs = []
    try:
        for p in procs:
            logs.append(p.communicate(
                timeout=max(1.0, deadline - time.monotonic()))[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for r, (p, log) in enumerate(zip(procs, logs)):
        assert p.returncode == 0, f"rank {r} of {shape}: {log[-4000:]}"
    out = []
    for r in range(world):
        with open(tmp / f"rank{r}.pkl", "rb") as f:
            out.append(pickle.load(f))
    return out


@contextlib.contextmanager
def one_rank_mesh(tmp, shape=(1,)):
    """A one-rank gloo group in this process and its CPU ``DeviceMesh``."""
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    dist.init_process_group("gloo", init_method=f"file://{tmp}/rendezvous",
                            rank=0, world_size=1)
    try:
        yield init_device_mesh("cpu", shape, mesh_dim_names=AXES[:len(shape)])
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the suites (run on the ranks)
# ---------------------------------------------------------------------------

def _stats(st) -> dict:
    return {f: int(getattr(st, f)) for f in STATS}


def suite_peels(mesh, rank, p):
    """The sharded peels and dense supports of ``core.distributed``."""
    import numpy as np
    import torch

    from repro_torch.core import distributed as D

    ax = mesh_axis(mesh.shape)
    n_dev = D.axis_size(mesh, ax)
    out = {"graphs": {}, "buckets": [], "collectives0": D.COLLECTIVES}
    for name, m, sup, tris, removable, thresh in p["graphs"]:
        tp = D.pad_triangles(tris, m, n_dev)
        alive0 = np.ones(m, bool)
        phi, merge = D._sharded_rounds(mesh, ax, sup, tp, alive0, None,
                                       None, torch.device("cpu"))
        alive, merge_t = D._sharded_rounds(mesh, ax, sup, tp, alive0,
                                           removable, thresh,
                                           torch.device("cpu"))
        out["graphs"][name] = dict(
            phi=D.peel_classes_sharded(mesh, sup, tp, alive0, axis=ax,
                                       device="cpu").numpy(),
            phi_rounds=phi.numpy(), sup=merge.sup.reshape(-1).numpy(),
            alive=D.local_threshold_peel_sharded(
                mesh, sup, tp, alive0, removable, thresh, axis=ax,
                device="cpu").numpy(),
            alive_rounds=(alive > 0).numpy(),
            sup_t=merge_t.sup.reshape(-1).numpy())
    for sup_b, tris_b, alive_b in p["buckets"]:
        phi, st = D.peel_classes_batched_sharded(mesh, sup_b, tris_b,
                                                 alive_b, axis=ax,
                                                 device="cpu")
        out["buckets"].append(dict(phi=phi.numpy(), stats=st.numpy()))
    out["local_truss"] = D.distributed_local_truss(
        mesh, *D.pad_parts(p["parts"], D.axis_size(mesh, "data")),
        axis="data", device="cpu").numpy()
    out["ring"] = D.ring_support_dense(mesh, p["A"], device="cpu").numpy()
    out["allgather"] = D.allgather_support_dense(mesh, p["A"],
                                                 device="cpu").numpy()
    out["collectives"] = D.COLLECTIVES
    return out


def suite_drivers(mesh, rank, p):
    """The drivers with ``mesh=`` on every graph of the payload."""
    import warnings

    from repro_torch.core import bottom_up as bu
    from repro_torch.core import maintain as mt
    from repro_torch.core import peel
    from repro_torch.core import top_down as td

    warnings.simplefilter("ignore")
    ax = mesh_axis(mesh.shape)
    kw = dict(mesh=mesh, mesh_axis=ax)
    out = {}
    for name, n, e, budget, steps, phi0 in p["rows"]:
        r = {}
        res = bu.bottom_up_decompose(n, e, budget, device="cpu", **kw)
        r["bu"] = (res.phi, _stats(res.stats))
        res = bu.lower_bounding(n, e, budget, device="cpu", **kw)
        r["lb"] = (res.lb, res.phi, res.in_gnew, _stats(res.stats))
        sup, st = bu.partitioned_support(n, e, budget, with_stats=True,
                                         **kw)
        r["ps"] = (sup, _stats(st))
        res = td.top_down_decompose(n, e, budget=budget, device="cpu", **kw)
        r["tdb"] = (res.phi, _stats(res.stats))
        res = td.top_down_decompose(n, e, device="cpu", **kw)
        r["td"] = (res.phi, _stats(res.stats))
        phi, st = peel.truss_decompose(
            n, e, engine="bottom-up", memory_budget=4 * budget, mesh=mesh,
            mesh_axes=AXES[:len(mesh.shape)], with_stats=True, device="cpu")
        r["truss_decompose"] = (phi, _stats(st))
        if steps is not None:
            res = mt.truss_maintain((n, e), phi0, steps, device="cpu", **kw)
            r["maintain"] = (res.phi, _stats(res.stats))
        out[name] = r
    return out


def suite_ladders(mesh, rank, p):
    """Retry ladders and the journals across ranks (a ("data",) mesh)."""
    import warnings

    import numpy as np
    import torch

    from repro_torch.core import bottom_up as bu
    from repro_torch.core import faults
    from repro_torch.core import top_down as td
    from repro_torch.kernels.frontier_peel import kernel as fk

    warnings.simplefilter("ignore")
    n, e, budget = p["n"], p["edges"], p["budget"]
    kw = dict(mesh=mesh, device="cpu")
    drivers = {
        "bottom-up": lambda **x: bu.bottom_up_decompose(n, e, budget, **kw,
                                                        **x),
        "top-down": lambda **x: td.top_down_decompose(n, e, budget=budget,
                                                      **kw, **x),
    }
    out = {}
    for name, rule in MESH_DROP_PLANS.items():
        plan = faults.FaultPlan([faults.FaultRule(kind="oom", **rule)])
        with faults.active(plan):
            res = drivers[name]()
        out[f"same plan {name}"] = (res.phi, _stats(res.stats), len(plan.log))
    # an OOM on rank 1 alone, at an injected dispatch and finalize, and a
    # real one raised by B1's wrapper inside a round
    for name, rule in (("bottom-up", dict(site="dispatch",
                                          where={"stage": 1})),
                       ("bottom-up", dict(site="finalize",
                                          where={"stage": 2})),
                       ("top-down", dict(site="finalize",
                                         where={"stage": "td"}))):
        plan = faults.FaultPlan(
            [faults.FaultRule(kind="oom", **rule)] if rank == 1 else [])
        with faults.active(plan):
            res = drivers[name]()
        out[f"rank 1 {name} {rule['site']}"] = (
            res.phi, _stats(res.stats), len(plan.log))
    # round 1's stage-1 dispatch fails on both ranks; its bucket has two
    # lanes, so at the first lane split (retry 2) each sub-bucket has one
    # lane, runs single-device, and fails on rank 1 alone
    plan = faults.FaultPlan(
        [faults.FaultRule(site="dispatch", kind="oom",
                          where={"stage": 1, "round": 1, "retry": 0})]
        + ([faults.FaultRule(site="dispatch", kind="oom",
                             where={"stage": 1, "retry": 2, "sub": 0})]
           if rank == 1 else []))
    with faults.active(plan):
        res = drivers["bottom-up"]()
    out["rank 1 bottom-up retry 2 one lane"] = (
        res.phi, _stats(res.stats), len(plan.log))
    real = fk.fused_round_live
    for name, nth in (("bottom-up", 2), ("top-down", 3)):
        calls = [0]

        def failing(*args, **kwargs):
            calls[0] += 1
            if rank == 1 and calls[0] == nth:
                raise torch.OutOfMemoryError("CUDA out of memory (test)")
            return real(*args, **kwargs)

        fk.fused_round_live = failing
        try:
            res = drivers[name]()
        finally:
            fk.fused_round_live = real
        out[f"rank 1 {name} B1 call {nth}"] = (res.phi, _stats(res.stats), 0)
    # a journal written at this world size, the run cut at round 3 on
    # every rank, then resumed
    cut = faults.FaultPlan([faults.FaultRule(
        site="partitioner", kind="error", where={"round": 3})])
    try:
        with faults.active(cut):
            drivers["bottom-up"](checkpoint_dir=p["journal"])
        out["journal cut"] = False
    except faults.InjectedFault:
        out["journal cut"] = True
    res = drivers["bottom-up"](checkpoint_dir=p["journal"], resume=True)
    out["journal resume"] = (res.phi, _stats(res.stats),
                             res.stats.resumed_round)
    # a time-gated journal: rank 0's clock (10 s a reading) decides for
    # every rank; rank 1's stands still
    ticks = [0.0]

    def clock():
        ticks[0] += 10.0 if rank == 0 else 0.0
        return ticks[0]

    journal = bu.RoundJournal(p["journal_time"], "time-gate", every="15s",
                              clock=clock, mesh=mesh)
    st = bu.OocStats()
    wrote = [journal.record("lb", i, {"x": np.arange(3)}, st)
             for i in range(6)]
    out["journal time gate"] = (wrote, st.checkpoints, journal.seq)
    return out


def suite_compress(mesh, rank, p):
    """``optim.compression.compressed_psum`` of this rank's gradient and
    error over the ("data",) group, for ``p["steps"]`` steps carrying the
    error: each step's mean and new error."""
    import torch

    from repro_torch.optim.compression import compressed_psum

    group = mesh.get_group("data")
    err = torch.from_numpy(p["error"][rank])
    out = []
    for g in p["grads"]:
        mean, err = compressed_psum(torch.from_numpy(g[rank]), err, group)
        out.append((mean.numpy(), err.numpy()))
    return out


def suite_lookup(mesh, rank, p):
    """``models.recsys.embedding.sharded_lookup`` of ``p["ids"]`` in
    ``p["table"]`` over a ("model",) mesh of every rank, and over the
    ("data",) mesh (no such axis: the take); the collectives it ran; and
    the ``ValueError`` of a table whose rows do not split evenly."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D
    from repro_torch.models.recsys.embedding import sharded_lookup

    model = init_device_mesh("cpu", (mesh.size(),),
                             mesh_dim_names=("model",))
    table, ids = torch.from_numpy(p["table"]), torch.from_numpy(p["ids"])
    c0 = D.COLLECTIVES
    out = {"model": sharded_lookup(table, ids, model).numpy()}
    out["collectives"] = D.COLLECTIVES - c0
    out["data"] = sharded_lookup(table, ids, mesh).numpy()
    try:
        sharded_lookup(torch.from_numpy(p["uneven"]), ids, model)
    except ValueError as e:
        out["uneven"] = str(e)
    return out


def ring_shard(batch: dict, index: int, n_ranks: int) -> dict:
    """Rank ``index``'s shard of a ring batch: its W node rows and its
    owner slab (1, P, Eb[, 3]) of the buckets."""
    out = {}
    for k, v in batch.items():
        if k in ("src_loc", "dst_loc", "edge_mask", "dst_pos"):
            out[k] = v[index:index + 1]
        else:
            w = len(v) // n_ranks
            out[k] = v[index * w:(index + 1) * w]
    return out


def suite_ring(mesh, rank, p):
    """``models.gnn.distributed`` over a ("data", "model") mesh of the
    same shape: ``ring_aggregate`` on a toy contribution, and the two ring
    losses' values and gradients on this rank's shard; the ring's
    collectives counted by ``launch.hlo_analysis`` over one forward."""
    import torch
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch import tree
    from repro_torch.configs.cells import value_and_grad
    from repro_torch.launch import hlo_analysis
    from repro_torch.models.gnn import distributed as RD

    ring = init_device_mesh("cpu", tuple(mesh.shape),
                            mesh_dim_names=("data", "model"))
    group, n, me = RD.ring_group(ring)
    toy = RD.ring_aggregate(
        lambda b: {"num": torch.full((3,), float(100 * me + b)),
                   "den": torch.full((2,), float(me))},
        {"num": torch.zeros(3), "den": torch.zeros(2)}, group, n, me)
    out = {"index": me, "toy": {k: v.numpy() for k, v in toy.items()}}
    for name, fn in (("eqv2", RD.eqv2_ring_loss), ("sage", RD.sage_ring_loss)):
        cfg, params, batch = p[name]
        params = tree.map_leaves(torch.from_numpy, params)
        local = {k: torch.from_numpy(v)
                 for k, v in ring_shard(batch, me, n).items()}
        loss, grads = value_and_grad(
            lambda q, b: fn(q, b, cfg, ring), params, local)
        out[name] = (float(loss),
                     [g.numpy() for g in tree.leaves(grads)])
    cfg, params, batch = p["sage"]
    local = {k: torch.from_numpy(v)
             for k, v in ring_shard(batch, me, n).items()}
    with torch.no_grad():
        out["analyze"] = hlo_analysis.analyze(
            lambda: RD.sage_ring_loss(tree.map_leaves(torch.from_numpy,
                                                      params),
                                      local, cfg, ring))
    return out


def _full(x):
    """A tree of (``D``)tensors as numpy arrays (a ``DTensor`` gathered
    whole); other leaves as they are."""
    import torch
    from torch.distributed.tensor import DTensor

    if isinstance(x, DTensor):
        x = x.full_tensor()
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    if isinstance(x, dict):
        return {k: _full(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return type(x)(_full(v) for v in x)
    return x


def gnn_cell(arch, cfg, batch):
    """A GNN training cell of the reduced ``cfg`` whose batch has the
    arrays of ``batch`` (numpy), built as ``configs.gnn_family`` builds
    its flat-graph cells (params replicated, edges over every mesh axis,
    nodes replicated); EquiformerV2's tree batch (``node_feat`` of rank 3)
    as its ``minibatch_lg`` cell (the trees over the data axes)."""
    from functools import partial

    import torch

    from repro_torch.configs import cells as C
    from repro_torch.configs import gnn_family as F
    from repro_torch.models.gnn import models as G

    init, loss = {"meshgraphnet": (G.mgn_init, G.mgn_loss),
                  "equiformer-v2": (G.eqv2_init, G.eqv2_loss),
                  "graphsage-reddit": (G.sage_init, G.sage_loss),
                  "gat-cora": (G.gat_init, G.gat_loss)}[arch]
    abs_b = {k: C.sds(v.shape, torch.from_numpy(v).dtype)
             for k, v in batch.items()}
    if batch["node_feat"].ndim == 3:
        loss = F.eqv2_tree_loss

        def specs(mesh):
            return C.shardings(mesh, {k: C.dp(mesh, *([None] * (v.ndim - 1)))
                                      for k, v in batch.items()})
    else:
        specs = partial(F._batch_specs, batch=abs_b)
    return F._train_cell(arch, "reduced", cfg,
                         lambda p, b: loss(p, b, cfg=cfg),
                         lambda: init(torch.Generator(), cfg), 0.0,
                         lambda mesh: (abs_b, specs(mesh)))


def suite_cells(mesh, rank, p):
    """The cells' mesh paths on real values: each case's cell built on a
    ("data", "model") mesh of the same shape, its real args (numpy in the
    payload) placed as ``DTensor``s by the cell's shardings, one step under
    ``common.use_mesh``, its outputs gathered whole.  Cases: ``("lm",
    cfg, shape, microbatches, args)``, ``("din", cfg, shape, args)``,
    ``("gnn", arch, cfg, args)``, and ``("take", V, ids)``: ``common.take``
    of a table whose rows are sharded over "model"."""
    import numpy as np
    import torch
    from torch.distributed.device_mesh import init_device_mesh
    from torch.distributed.tensor import distribute_tensor
    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch import tree
    from repro_torch.configs import lm_family, recsys_family
    from repro_torch.launch.dryrun import _placed
    from repro_torch.models import common as cm

    m = init_device_mesh("cpu", tuple(mesh.shape),
                         mesh_dim_names=("data", "model"))

    def place(t, spec):
        return distribute_tensor(t, m, cm.placements(m, spec))

    out = {}
    for name, case in p.items():
        kind = case[0]
        if kind == "take":
            _, V, ids = case
            table = torch.arange(V * 3, dtype=torch.float32).reshape(V, 3)
            with cm.use_mesh(m):
                got = cm.take(place(table, cm.P("model", None)),
                              torch.from_numpy(ids))
            out[name] = _full(got)
            continue
        if kind == "lm":
            _, cfg, sh, mb, args = case
            built = lm_family._build(cfg, sh, mb, m)
        elif kind == "din":
            _, cfg, sh, args = case
            built = recsys_family._build(cfg, sh, m)
        else:
            _, arch, cfg, args = case
            built = gnn_cell(arch, cfg, args[2]).build(m)
        fn, _, in_sh = built[:3]
        real = tree.map_leaves(lambda a: torch.from_numpy(np.array(a)), args)
        with cm.use_mesh(m):
            dargs = _placed(real, in_sh, m, place)
            with implicit_replication():
                res = fn(*dargs)
        out[name] = _full(res)
    return out


SUITES = {"peels": suite_peels, "drivers": suite_drivers,
          "ladders": suite_ladders, "compress": suite_compress,
          "lookup": suite_lookup, "ring": suite_ring, "cells": suite_cells}


def graphs():
    """The drivers' graphs: the conformance corpus and a small R-MAT, with
    the budget and, on two of them, the edits each driver gets."""
    import numpy as np

    from repro.core.graph import canonical_edges
    from repro.data import graphgen
    from tests.conftest import conformance_corpus

    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = graphgen.rmat(6, 6, seed=1)
    out.append(("rmat6", n, canonical_edges(e, n)))
    rows = []
    for name, n, e in out:
        steps = None
        if name in ("er", "rmat"):
            rng = np.random.default_rng(len(e))
            present = {tuple(x) for x in e.tolist()}
            dels = [("delete", *map(int, e[i]))
                    for i in rng.choice(len(e), 3, replace=False)]
            ins = []
            while len(ins) < 3:
                u, v = sorted(int(x) for x in rng.integers(0, n, 2))
                if u != v and (u, v) not in present:
                    present.add((u, v))
                    ins.append(("insert", u, v))
            steps = [s for pair in zip(dels, ins) for s in pair]
        rows.append((name, n, e, max(64, len(e) // 3), steps))
    return rows


# the JAX package's drivers, run in a subprocess by the drivers tests on
# forced host devices: the mesh runs of bottom-up and budgeted and
# unbudgeted top-down on the corpus at each shape, the mesh-drop plans at
# (2,), and once on one device the calls whose results do not depend on the
# mesh (lower bounds, supports, maintenance); prints one JSON object
JAX_MESH_SCRIPT = r"""
import json, sys, warnings
import jax
import numpy as np
sys.path.insert(0, ".")
from repro.core import bottom_up as bu, faults, maintain as mt
from repro.core import top_down as td
from repro.core.serial import alg2_truss
from tests.torch_mesh import MESH_DROP_PLANS, STATS, graphs, mesh_axis

warnings.simplefilter("ignore")
shapes = [tuple(s) for s in json.loads(sys.argv[1])]
st = lambda s: {f: int(getattr(s, f)) for f in STATS}
rows = graphs()
out = {"single": {}}
for name, n, e, budget, steps in rows if sys.argv[2] == "single" else ():
    lb = bu.lower_bounding(n, e, budget)
    sup, pst = bu.partitioned_support(n, e, budget, with_stats=True)
    one = {"lb": [lb.lb.tolist(), lb.phi.tolist(), lb.in_gnew.tolist()],
           "ps": [sup.tolist(), st(pst)]}
    if steps is not None:
        res = mt.truss_maintain((n, e), alg2_truss(n, e), steps)
        one["maintain"] = [res.phi.tolist(), st(res.stats)]
    out["single"][name] = one
for shape in shapes:
    mesh = jax.make_mesh(shape, ("data", "tri")[:len(shape)],
                         devices=jax.devices()[:int(np.prod(shape))])
    kw = dict(mesh=mesh, mesh_axis=mesh_axis(shape))
    res = {}
    for name, n, e, budget, _ in rows[:-1]:
        b = bu.bottom_up_decompose(n, e, budget, **kw)
        t = td.top_down_decompose(n, e, budget=budget, **kw)
        u = td.top_down_decompose(n, e, **kw)
        res[name] = {"bu": [b.phi.tolist(), st(b.stats)],
                     "tdb": [t.phi.tolist(), st(t.stats)],
                     "td": [u.phi.tolist(), st(u.stats)]}
    if shape == (2,):
        name, n, e, budget, _ = rows[0]
        for drv, rule in MESH_DROP_PLANS.items():
            plan = faults.FaultPlan([faults.FaultRule(kind="oom", **rule)])
            with faults.active(plan):
                r = (bu.bottom_up_decompose(n, e, budget, **kw)
                     if drv == "bottom-up" else
                     td.top_down_decompose(n, e, budget=budget, **kw))
            res["same plan " + drv] = [r.phi.tolist(), st(r.stats),
                                       len(plan.log)]
    out[str(list(shape))] = res
print(json.dumps(out))
"""


def drivers_payload() -> dict:
    """The drivers suite's rows: each graph with its oracle phi."""
    from repro.core.serial import alg2_truss

    return {"rows": [(name, n, e, budget, steps, alg2_truss(n, e))
                     for name, n, e, budget, steps in graphs()]}


def drivers_payload_oracle(name: str):
    """``alg2_truss`` of one of :func:`graphs`."""
    from repro.core.serial import alg2_truss

    for row in graphs():
        if row[0] == name:
            return alg2_truss(row[1], row[2])
    raise KeyError(name)


def ladders_payload(journal) -> dict:
    """The ladders suite's graph (the corpus's first, as in the JAX
    script's mesh-drop plans) and the journal directory its ranks share."""
    name, n, e, budget, _ = graphs()[0]
    return dict(n=n, edges=e, budget=budget, journal=str(journal),
                journal_time=f"{journal}_time")


def jax_mesh_run(shapes, single: bool,
                 timeout: float = 300.0) -> subprocess.Popen:
    """Start :data:`JAX_MESH_SCRIPT` on ``shapes`` (and its one-device
    calls with ``single``); read it with :func:`jax_mesh_result`."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_MESH_SCRIPT,
         json.dumps([list(s) for s in shapes]),
         "single" if single else "mesh"], env=env, cwd=str(ROOT),
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
    proc.timeout = timeout
    return proc


def jax_mesh_result(proc) -> dict:
    try:
        so, se = proc.communicate(timeout=proc.timeout)
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait()
    assert proc.returncode == 0, se[-4000:]
    return json.loads(so.strip().splitlines()[-1])


if __name__ == "__main__":
    sys.modules["jax"] = None
    sys.modules["repro"] = None
    suite, rendezvous, rank, shape, payload, dest = sys.argv[1:7]
    rank = int(rank)
    shape = tuple(int(s) for s in shape.split(","))
    import torch
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    torch.set_num_threads(1)
    world = 1
    for s in shape:
        world *= s
    dist.init_process_group("gloo", init_method=f"file://{rendezvous}",
                            rank=rank, world_size=world)
    mesh = init_device_mesh("cpu", shape, mesh_dim_names=AXES[:len(shape)])
    with open(payload, "rb") as f:
        result = SUITES[suite](mesh, rank, pickle.load(f))
    with open(dest, "wb") as f:
        pickle.dump(result, f)
    # no rank tears its pairs down while another still talks to it
    dist.barrier()
    dist.destroy_process_group()
