"""Dry run of every (arch x shape x mesh) cell on a fake process group
(port of the JAX package's ``launch/dryrun.py``).

The reference lowers and compiles each cell for a TPU pod from
``ShapeDtypeStruct`` inputs and reads XLA's memory and cost analyses.  The
port traces each cell's step once on the production mesh with no device
and no allocation:

* a fake process group of the mesh's size (backend ``"fake"``, whose
  collectives complete at once), this process as rank 0;
* the step's inputs as ``DTensor``s placed by the cell's shardings (a
  ``None`` sharding: replicated) over rank 0's shards on the ``meta``
  device (a shape, a dtype and no storage), run under
  ``common.use_mesh`` so the model's ``shard`` calls redistribute, and
  ``implicit_replication`` for the plain tensors the model makes itself;
  the two ring cells run SPMD on rank 0's local shards, as ``shard_map``
  does;
* ``hlo_analysis.Counter`` over rank 0's local ops: matmul flops and
  bytes, collective bytes and counts, and the peak of the bytes the step
  allocates.

Each record keeps the reference's keys, with ``trace_s`` in place of
``lower_s`` and ``compile_s``.  Its memory fields are per device (rank
0's shards): ``arg_bytes`` the inputs, ``out_bytes`` the outputs the step
allocates (an input updated in place is not an output), ``temp_bytes`` the
peak of the bytes the step allocates, outputs included (the counterpart of
``max_memory_allocated`` less the inputs); ``code_bytes`` is 0.  The
roofline terms use one NVIDIA H100 SXM's data-sheet figures, not
measurements:

  compute    = flops_dev / 989e12   (dense bf16, NVIDIA H100 data sheet)
  memory     = dot_bytes_dev / 3.35e12   (HBM3, same data sheet)
  collective = comm_bytes_dev / 50e9   (one 400 Gb/s NIC a GPU: a (16, 16)
                                        mesh of H100s spans nodes of 8, so
                                        every axis crosses nodes)

``xla_cost_flops`` and ``loop_aware_flops`` both hold the one eager count.
A cell that fails is recorded with its error and the run goes on.  The
fake group is destroyed when the run ends, failed or not; nothing here
touches a card.

Usage (no card needed):
  python -m repro_torch.launch.dryrun --arch gat-cora --shape full_graph_sm
  python -m repro_torch.launch.dryrun --all [--multi-pod | --both-meshes]
      [--out results.json] [--jobs N]
"""

from __future__ import annotations

import argparse
import contextlib
import json
import time
import traceback

PEAK_FLOPS = 989e12      # bf16, dense, one H100 SXM (data sheet)
HBM_BW = 3.35e12         # bytes/s, one H100 SXM (data sheet)
LINK_BW = 50e9           # bytes/s, one 400 Gb/s NIC a GPU (data sheet)

MESHES = {"pod16x16": False, "2pod16x16": True}


@contextlib.contextmanager
def fake_group(world_size: int):
    """A fake process group of ``world_size`` ranks, this process rank 0;
    destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0,
                            world_size=world_size)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _placed(args, shardings, mesh, place):
    """``args`` with every tensor leaf replaced by ``place(leaf, spec)``:
    ``shardings`` is a tree like ``args`` whose ``NamedSharding`` or None
    nodes apply to their whole subtree (None: replicated)."""
    import torch

    from repro_torch.configs.cells import NamedSharding
    from repro_torch.models.common import P

    def walk(a, s):
        if s is None or isinstance(s, NamedSharding):
            spec = P() if s is None else s.spec
            return _map(a, lambda t: place(t, spec))
        if isinstance(a, dict):
            return {k: walk(a[k], s[k]) for k in a}
        return type(a)(walk(x, y) for x, y in zip(a, s))

    def _map(a, fn):
        if isinstance(a, torch.Tensor):
            return fn(a)
        if isinstance(a, dict):
            return {k: _map(v, fn) for k, v in a.items()}
        if isinstance(a, (list, tuple)):
            return type(a)(_map(v, fn) for v in a)
        return a

    return walk(args, shardings)


def _meta_dtensor(mesh):
    """(abstract tensor, spec) -> a ``DTensor`` of rank 0's shard on the
    ``meta`` device (the first chunk along every sharded mesh dim,
    ``torch.chunk``'s sizes)."""
    import torch
    from torch.distributed.tensor import DTensor, Shard

    from repro_torch.models.common import placements

    def place(t, spec):
        pl = placements(mesh, spec)
        local = list(t.shape)
        for i, p in enumerate(pl):
            if isinstance(p, Shard):
                local[p.dim] = -(-local[p.dim] // mesh.size(i))
        return DTensor.from_local(
            torch.empty(local, dtype=t.dtype, device="meta"), mesh, pl,
            run_check=False,
            shape=t.shape, stride=t.stride())

    return place


def _storages(tree) -> dict:
    """Unique local storages of a tree's tensors: pointer -> bytes."""
    import torch
    from torch.distributed.tensor import DTensor
    from torch.utils._pytree import tree_flatten

    out = {}
    for t in tree_flatten(tree)[0]:
        if isinstance(t, DTensor):
            t = t.to_local()
        if isinstance(t, torch.Tensor):
            st = t.untyped_storage()
            out[st._cdata] = st.nbytes()
    return out


def run_cell(cell, mesh, mesh_name: str) -> dict:
    rec = {"arch": cell.arch, "shape": cell.shape, "kind": cell.kind,
           "mesh": mesh_name, "model_flops": cell.model_flops,
           "notes": cell.notes}
    t0 = time.time()
    try:
        from torch.distributed.tensor.experimental import implicit_replication

        from repro_torch.launch.hlo_analysis import Counter
        from repro_torch.models.common import use_mesh

        built = cell.build(mesh)
        fn, args, in_sh = built[:3]
        with use_mesh(mesh):
            dargs = _placed(args, in_sh, mesh, _meta_dtensor(mesh))
            arg_st = _storages(dargs)
            with implicit_replication(), Counter() as counter:
                out = fn(*dargs)
            out_st = _storages(out)
        t_trace = time.time()
        n_dev = mesh.size()
        coll = {"bytes": counter.result()["collective_bytes"],
                "counts": counter.result()["collective_counts"]}
        flops_dev = float(counter.flops)
        bytes_dev = float(counter.dot_bytes)
        comm_dev = float(sum(coll["bytes"].values()))
        rec.update({
            "ok": True,
            "trace_s": round(t_trace - t0, 1),
            "n_devices": n_dev,
            "flops_per_device": flops_dev,
            "bytes_per_device": bytes_dev,
            "xla_cost_flops": flops_dev,
            "loop_aware_flops": flops_dev,
            "collective_bytes_per_device": comm_dev,
            "collectives": coll,
            "arg_bytes": int(sum(arg_st.values())),
            "out_bytes": int(sum(b for k, b in out_st.items()
                                 if k not in arg_st)),
            "temp_bytes": int(counter.peak_bytes),
            "code_bytes": 0,
            "ops": counter.ops,
            "t_compute": flops_dev / PEAK_FLOPS,
            "t_memory": bytes_dev / HBM_BW,
            "t_collective": comm_dev / LINK_BW,
        })
        terms = {"compute": rec["t_compute"], "memory": rec["t_memory"],
                 "collective": rec["t_collective"]}
        rec["bottleneck"] = max(terms, key=terms.get)
        total_flops = flops_dev * n_dev
        rec["model_flops_ratio"] = (cell.model_flops / total_flops
                                    if total_flops else 0.0)
        rec["roofline_fraction"] = (
            rec["t_compute"] / max(max(terms.values()), 1e-30))
    except Exception as e:  # noqa: BLE001 — record and continue
        rec.update({"ok": False, "error": f"{type(e).__name__}: {e}",
                    "traceback": traceback.format_exc()[-6000:]})
    rec["total_s"] = round(time.time() - t0, 1)
    return rec


def select_cells(arch=None, shape=None) -> list:
    from repro_torch.configs import registry

    cells = []
    for a in registry.ARCHS:
        if arch and a != arch:
            continue
        for s, cell in registry.get_cells(a).items():
            if shape and s != shape:
                continue
            cells.append(cell)
    return cells


def _run_task(task):
    """One (mesh name, arch, shape) dry run in a fake group of its own."""
    mesh_name, arch, shape = task
    from repro_torch.configs import registry
    from repro_torch.launch.mesh import make_production_mesh

    multi = MESHES[mesh_name]
    with fake_group(512 if multi else 256):
        return run_cell(registry.get_cell(arch, shape),
                        make_production_mesh(multi_pod=multi), mesh_name)


def _report(rec) -> None:
    key = f"{rec['arch']}×{rec['shape']}"
    status = "OK" if rec.get("ok") else f"FAIL {rec.get('error')}"
    extra = ""
    if rec.get("ok"):
        extra = (f" compute={rec['t_compute']:.3e}s"
                 f" memory={rec['t_memory']:.3e}s"
                 f" coll={rec['t_collective']:.3e}s"
                 f" bottleneck={rec['bottleneck']}"
                 f" temp={rec['temp_bytes']/2**30:.2f}GiB"
                 f" trace={rec['trace_s']}s")
    print(f"[dryrun] {key} {rec['mesh']}: {status}{extra}", flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default=None)
    ap.add_argument("--shape", default=None)
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--both-meshes", action="store_true")
    ap.add_argument("--out", default=None)
    ap.add_argument("--jobs", type=int, default=1,
                    help="worker processes, each tracing whole cells")
    args = ap.parse_args(argv)

    names = (list(MESHES) if args.both_meshes
             else ["2pod16x16" if args.multi_pod else "pod16x16"])
    cells = select_cells(args.arch, args.shape)
    if not cells:
        raise SystemExit("no cells matched")
    tasks = [(m, c.arch, c.shape) for m in names for c in cells]

    results = [None] * len(tasks)
    if args.jobs <= 1:
        for i, task in enumerate(tasks):
            print(f"[dryrun] {task[1]}×{task[2]} on {task[0]} ...",
                  flush=True)
            results[i] = _run_task(task)
            _report(results[i])
    else:
        import multiprocessing as mp

        # the longest traces start first: the rings (every ring step of
        # every layer), then the LMs' prefill (every attention tile) and
        # training (every microbatch)
        order = sorted(range(len(tasks)), key=lambda i: (
            _trace_rank(tasks[i]), i))
        with mp.get_context("spawn").Pool(args.jobs) as pool:
            for i, rec in pool.imap_unordered(
                    _indexed, [(i, tasks[i]) for i in order]):
                results[i] = rec
                _report(rec)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1)
    n_ok = sum(r.get("ok", False) for r in results)
    print(f"[dryrun] {n_ok}/{len(results)} cells traced")
    return results


def _indexed(item):
    i, task = item
    return i, _run_task(task)


def _trace_rank(task) -> int:
    from repro_torch.configs import registry

    _, arch, shape = task
    cell = registry.get_cell(arch, shape)
    if "ring" in cell.notes:
        return 0
    if arch in registry.LM_ARCHS and cell.kind in ("prefill", "train"):
        return 1
    return 2


if __name__ == "__main__":
    main()
