"""The port's cell layer (``configs/cells.py``, ``lm_family``, the cell
builders of ``gnn_family`` and ``recsys_family``, ``CELLS`` and the
registry) and the spec trees against the JAX package's.

Every cell's key, kind, model flops, donated args and notes equal the
reference's; on a (4, 2) ("data", "model") mesh every cell's built args
have the reference's shapes and dtypes and every input its resolved spec.
The reference's cells are built once, in one subprocess with 8 forced host
devices; the port's on a fake 8-rank process group (destroyed at the end
of the module).  EquiformerV2 x ``minibatch_lg``'s union-graph loss equals
the reference's per-tree ``vmap`` at reduced widths.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.models import transformer as JT
from repro.models.gnn import models as JG
from repro.models.recsys import din as JDIN
from repro.optim import adamw as jadamw
from repro_torch import tree
from repro_torch.configs import cells as C
from repro_torch.configs import gnn_family
from repro_torch.configs import registry as tregistry
from repro_torch.models import transformer as T
from repro_torch.models.gnn import models as G
from repro_torch.models.recsys import din as DIN
from repro_torch.optim import adamw

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CELL_KEYS = [c.key for c in jregistry.all_cells()]

# the reference's cells on a (4, 2) host mesh: for each cell, each input's
# leaves (shape, dtype) and the resolved spec of each of its shardings
_JAX_CELLS = r"""
import json
import jax
from jax.sharding import NamedSharding
from repro.configs import registry

mesh = jax.make_mesh((4, 2), ("data", "model"))


def spec(s):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(s)]


out = {}
for cell in registry.all_cells():
    fn, args, in_sh = cell.build(mesh)[:3]
    rec = {"args": [], "specs": []}
    for a, s in zip(args, in_sh):
        rec["args"].append([[list(x.shape), jax.numpy.dtype(x.dtype).name]
                            for x in jax.tree.leaves(a)])
        rec["specs"].append(None if s is None else [
            spec(n.spec) for n in jax.tree.leaves(
                s, is_leaf=lambda x: isinstance(x, NamedSharding))])
    out[cell.key] = rec
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def jax_cells():
    env = dict(os.environ, PYTHONPATH=os.path.join(_ROOT, "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", _JAX_CELLS],
                       capture_output=True, text=True, timeout=300, env=env,
                       cwd=_ROOT)
    assert p.returncode == 0, p.stderr[-3000:]
    return json.loads(p.stdout.strip().splitlines()[-1])


@pytest.fixture(scope="module")
def fake_mesh():
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=0, world_size=8)
    try:
        yield init_device_mesh("cpu", (4, 2), mesh_dim_names=("data",
                                                              "model"))
    finally:
        dist.destroy_process_group()


def _spec(p):
    return [list(e) if isinstance(e, tuple) else e for e in tuple(p)]


def _dtype(t: torch.Tensor) -> str:
    return str(t.dtype).replace("torch.", "")


def test_registry_covers_the_reference_cells():
    """40 cells: 5 LM x 4 + 4 GNN x 4 + 1 recsys x 4, in the reference's
    order, each from its arch's module."""
    cells = list(tregistry.all_cells())
    assert len(cells) == 40
    assert [c.key for c in cells] == CELL_KEYS
    for arch in tregistry.ARCHS:
        assert tregistry.get_module(arch).CELLS is tregistry.get_cells(arch)
        for shape, cell in tregistry.get_cells(arch).items():
            assert tregistry.get_cell(arch, shape) is cell
    with pytest.raises(ValueError):
        tregistry.get_cells("bert")


@pytest.mark.parametrize("key", CELL_KEYS)
def test_cell_fields_equal_the_reference(key):
    arch, shape = key.split("×")
    want = jregistry.get_cell(arch, shape)
    got = tregistry.get_cell(arch, shape)
    assert (got.arch, got.shape, got.key, got.kind, got.donate, got.notes) \
        == (want.arch, want.shape, want.key, want.kind, want.donate,
            want.notes)
    assert got.model_flops == want.model_flops


@pytest.mark.parametrize("key", CELL_KEYS)
def test_cell_args_and_specs_equal_the_reference(key, jax_cells, fake_mesh):
    arch, shape = key.split("×")
    fn, args, in_sh = tregistry.get_cell(arch, shape).build(fake_mesh)[:3]
    want = jax_cells[key]
    assert len(args) == len(want["args"]) == len(in_sh)
    for a, w in zip(args, want["args"]):
        leaves = tree.leaves(a)
        assert all(x.device.type == "meta" for x in leaves)
        assert [[list(x.shape), _dtype(x)] for x in leaves] == w
    for s, w in zip(in_sh, want["specs"]):
        if w is None:
            assert s is None
            continue
        got = [_spec(n.spec) for n in tree.leaves(s)] \
            if not isinstance(s, C.NamedSharding) else [_spec(s.spec)]
        assert got == w


# ---------------------------------------------------------------------------
# spec trees
# ---------------------------------------------------------------------------

def _jspecs(t):
    from jax.sharding import PartitionSpec as JP

    if isinstance(t, JP):
        return ("P", _spec(t))
    if isinstance(t, dict):
        return {k: _jspecs(v) for k, v in t.items()}
    return [_jspecs(v) for v in t]


def _tspecs(t):
    from repro_torch.models.common import P

    if isinstance(t, P):
        return ("P", _spec(t))
    if isinstance(t, dict):
        return {k: _tspecs(v) for k, v in t.items()}
    return [_tspecs(v) for v in t]


@pytest.mark.parametrize("arch", jregistry.LM_ARCHS)
def test_lm_spec_trees_equal_the_reference(arch):
    jcfg, tcfg = jregistry.get_config(arch), tregistry.get_config(arch)
    assert _tspecs(T.param_specs(tcfg)) == _jspecs(JT.param_specs(jcfg))
    for long in (False, True):
        assert _tspecs(T.cache_specs(tcfg, long_context=long)) == \
            _jspecs(JT.cache_specs(jcfg, long_context=long))


def test_din_param_specs_equal_the_reference():
    cfg = jregistry.get_config("din")
    assert _tspecs(DIN.param_specs(tregistry.get_config("din"))) == \
        _jspecs(JDIN.param_specs(cfg))


@pytest.mark.parametrize("arch", ["qwen2.5-14b", "phi3.5-moe-42b-a6.6b",
                                  "din"])
@pytest.mark.parametrize("data_size", [16, 32])
@pytest.mark.parametrize("data_axes", [("data",), ("pod", "data")])
def test_zero_specs_equal_the_reference(arch, data_size, data_axes):
    if arch == "din":
        jp = JDIN.param_specs(jregistry.get_config(arch))
        tp = DIN.param_specs(tregistry.get_config(arch))
        jshape = jax.eval_shape(lambda: JDIN.din_init(
            jax.random.PRNGKey(0), jregistry.get_config(arch)))
        tshape = C.abstract_params(lambda: DIN.din_init(
            torch.Generator(), tregistry.get_config(arch)))
    else:
        jp = JT.param_specs(jregistry.get_config(arch))
        tp = T.param_specs(tregistry.get_config(arch))
        jshape = jax.eval_shape(lambda: JT.init_params(
            jax.random.PRNGKey(0), jregistry.get_config(arch)))
        tshape = C.abstract_params(lambda: T.init_params(
            torch.Generator(), tregistry.get_config(arch)))
    want = jadamw.zero_specs(jp, jshape, data_axes=data_axes,
                             data_size=data_size)
    got = adamw.zero_specs(tp, tshape, data_axes=data_axes,
                           data_size=data_size)
    assert _tspecs(got) == _jspecs(want)


def test_abstract_params_draw_nothing():
    """The abstract init has the real init's shapes and dtypes on ``meta``
    and leaves the generator where it was."""
    cfg = dataclasses.replace(tregistry.get_config("gemma3-4b"), n_layers=2,
                              d_model=64, d_ff=128, vocab=256, d_head=16)
    gen = torch.Generator().manual_seed(0)
    state = gen.get_state().clone()
    abstract = C.abstract_params(lambda: T.init_params(gen, cfg))
    assert torch.equal(gen.get_state(), state)
    real = T.init_params(torch.Generator().manual_seed(0), cfg)
    for a, r in zip(tree.leaves(abstract), tree.leaves(real)):
        assert a.device.type == "meta"
        assert (a.shape, a.dtype) == (r.shape, r.dtype)


# ---------------------------------------------------------------------------
# EquiformerV2 x minibatch_lg: union graph against the reference's vmap
# ---------------------------------------------------------------------------

def test_eqv2_tree_loss_equals_the_reference_vmap():
    cfg = G.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=2, m_max=2,
                               n_heads=4, d_in=8)
    jcfg = JG.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=2, m_max=2,
                                 n_heads=4, d_in=8)
    rng = np.random.default_rng(0)
    B, nt = 3, 7                         # fanouts (2, 2): 1 + 2 + 4 nodes
    et = nt - 1
    parent = np.array([0, 0, 1, 1, 2, 2])
    child = np.arange(1, nt)
    ei = np.broadcast_to(np.stack([child, parent], 1), (B, et, 2)).astype(
        np.int32).copy()
    batch = {
        "node_feat": rng.standard_normal((B, nt, 8)).astype(np.float32),
        "positions": rng.standard_normal((B, nt, 3)).astype(np.float32),
        "edge_index": ei,
        "edge_mask": rng.random((B, et)) < 0.8,
        "targets": rng.standard_normal(B).astype(np.float32),
    }
    params = G.eqv2_init(torch.Generator().manual_seed(0), cfg)
    jparams = tree.map_leaves(lambda t: jnp.asarray(t.numpy()), params)

    def jloss(p, b):
        def per_tree(nf, pos, e, m):
            return JG.eqv2_forward(p, {"node_feat": nf, "positions": pos,
                                       "edge_index": e, "edge_mask": m},
                                   jcfg)[0, 0]
        out = jax.vmap(per_tree)(b["node_feat"], b["positions"],
                                 b["edge_index"], b["edge_mask"])
        return jnp.mean(jnp.square(out - b["targets"]))

    want = float(jax.jit(jloss)(jparams, {k: jnp.asarray(v)
                                          for k, v in batch.items()}))
    got = float(gnn_family.eqv2_tree_loss(
        params, {k: torch.as_tensor(v) for k, v in batch.items()}, cfg))
    np.testing.assert_allclose(got, want, rtol=1e-5)


def test_grad_specs_change_nothing_without_a_mesh():
    """``make_train_step(grad_specs=)`` outside ``use_mesh`` equals the step
    without them bit for bit (the reference's ``shard`` is the identity
    there), at one and two microbatches."""
    from repro_torch.configs.reduced import make_reduced

    cfg, init_fn, loss_fn, batch_fn = make_reduced("gemma3-4b", device="cpu")
    specs = adamw.zero_specs(T.param_specs(cfg), init_fn(),
                             data_axes=("data",), data_size=4)["master"]
    ocfg = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=10)
    for mb in (1, 2):
        runs = []
        for gs in (None, specs):
            params = init_fn()
            state = adamw.init_state(params)
            step = C.make_train_step(loss_fn, ocfg, mb, grad_specs=gs)
            params, state, m = step(params, state, batch_fn(0))
            runs.append((float(m["loss"]), tree.leaves(params)))
        assert runs[0][0] == runs[1][0]
        for a, b in zip(runs[0][1], runs[1][1]):
            assert torch.equal(a, b)
