"""The port's GNN ring (``models/gnn/distributed.py``) against the JAX
package's.

``bucket_edges_by_owner`` and ``pad_nodes`` array for array;
``ring_aggregate`` on a toy contribution against the plain sum; the two
ring losses and their gradients on one gloo rank (in this process) and on
four gloo ranks (``torch_mesh.spawn``, a (2, 2) ("data", "model") mesh),
each held to the port's plain losses on the same graph and to the
reference's ring on a forced 4-device (2, 2) host mesh, within the
reference test's tolerances: the loss at rtol 2e-4, every gradient within
5e-3 of its largest magnitude.  The ring's collectives over a forward are
counted by ``launch.hlo_analysis`` on the four ranks.
"""

import os
import pickle
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro.models.gnn import distributed as JRD
from repro_torch import tree
from repro_torch.configs.cells import value_and_grad
from repro_torch.core import graph as glib
from repro_torch.models.gnn import distributed as RD
from repro_torch.models.gnn import models as G

import torch_mesh

LOSS_RTOL = 2e-4
GRAD_REL = 5e-3
N, N_PAD = 60, 64


def _graph():
    rng = np.random.default_rng(0)
    mask = rng.random((N, N)) < 0.15
    iu = np.triu_indices(N, 1)
    ce = glib.canonical_edges(np.stack(iu, 1)[mask[iu]], N)
    ei = np.concatenate([ce, ce[:, ::-1]]).astype(np.int32)
    return rng, ei


def _cases(n_ranks: int) -> dict:
    """Both losses' (cfg, numpy params, ring batch) and their plain
    batches, from one seed."""
    rng, ei = _graph()
    nf = rng.standard_normal((N, 8)).astype(np.float32)
    pos = rng.standard_normal((N, 3)).astype(np.float32)
    tgt = rng.standard_normal(N).astype(np.float32)
    labels = rng.integers(0, 4, N).astype(np.int32)
    lmask = (rng.random(N) < 0.6).astype(np.float32)
    bk = RD.bucket_edges_by_owner(N_PAD, ei, pos, n_ranks, pad_factor=4.0)
    buckets = {k: v for k, v in bk.items() if k != "overflow"}
    pad = lambda a: RD.pad_nodes(a, N_PAD)
    ecfg = G.EquiformerV2Config(n_layers=2, d_hidden=16, l_max=2, m_max=2,
                                n_heads=4, d_in=8)
    scfg = G.GraphSAGEConfig(n_layers=2, d_hidden=16, d_in=8, n_classes=4)
    numpy = lambda t: tree.map_leaves(lambda x: x.numpy(), t)
    eparams = numpy(G.eqv2_init(torch.Generator().manual_seed(0), ecfg))
    sparams = numpy(G.sage_init(torch.Generator().manual_seed(1), scfg))
    return {
        "eqv2": (ecfg, eparams, {
            "node_feat": pad(nf), "positions": pad(pos),
            "targets": pad(tgt), "node_mask": pad(np.ones(N, np.float32)),
            **buckets}),
        "sage": (scfg, sparams, {
            "node_feat": pad(nf), "labels": pad(labels),
            "label_mask": pad(lmask),
            **{k: buckets[k] for k in ("src_loc", "dst_loc", "edge_mask")}}),
        "plain": {
            "eqv2": {"node_feat": nf, "edge_index": ei, "positions": pos,
                     "targets": tgt, "node_mask": np.ones(N, np.float32)},
            "sage": {"node_feat": nf, "edge_index": ei, "labels": labels,
                     "label_mask": lmask}},
    }


def _plain(cases) -> dict:
    out = {}
    for name, loss in (("eqv2", G.eqv2_loss), ("sage", G.sage_loss)):
        cfg, params, _ = cases[name]
        batch = {k: torch.as_tensor(v) for k, v in cases["plain"][name].items()}
        l, g = value_and_grad(lambda p, b: loss(p, b, cfg),
                              tree.map_leaves(torch.from_numpy, params), batch)
        out[name] = (float(l), [x.numpy() for x in tree.leaves(g)])
    return out


def _close(got, want, where):
    np.testing.assert_allclose(got[0], want[0], rtol=LOSS_RTOL,
                               err_msg=where)
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1], want[1]):
        assert np.max(np.abs(a - b)) <= GRAD_REL * (np.max(np.abs(b))
                                                    + 1e-6), where


_JAX_RING = r"""
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from repro.models.gnn import models as G
from repro.models.gnn.distributed import eqv2_ring_loss, sage_ring_loss

with open(sys.argv[1], "rb") as f:
    p = pickle.load(f)
mesh = jax.make_mesh((2, 2), ("data", "model"))
out = {}
for name, fn, cfg in (
        ("eqv2", eqv2_ring_loss, G.EquiformerV2Config(**p["eqv2"][0])),
        ("sage", sage_ring_loss, G.GraphSAGEConfig(**p["sage"][0]))):
    params = jax.tree.map(jnp.asarray, p[name][1])
    batch = {k: jnp.asarray(v) for k, v in p[name][2].items()}
    with mesh:
        loss, g = jax.jit(jax.value_and_grad(
            lambda q: fn(q, batch, cfg, mesh)))(params)
    out[name] = (float(loss), [np.asarray(x) for x in jax.tree.leaves(g)])
with open(sys.argv[2], "wb") as f:
    pickle.dump(out, f)
"""


@pytest.fixture(scope="module")
def four(tmp_path_factory):
    """The cases at four ranks, the port's rank results and the
    reference's ring on a forced 4-device host mesh."""
    import dataclasses

    tmp = tmp_path_factory.mktemp("ring4")
    cases = _cases(4)
    ranks = torch_mesh.spawn("ring", (2, 2), cases, tmp / "ranks",
                             timeout=300)
    payload = {k: (dataclasses.asdict(cases[k][0]), cases[k][1], cases[k][2])
               for k in ("eqv2", "sage")}
    with open(tmp / "jax_in.pkl", "wb") as f:
        pickle.dump(payload, f)
    env = dict(os.environ, PYTHONPATH=str(torch_mesh.ROOT / "src"),
               XLA_FLAGS="--xla_force_host_platform_device_count=4")
    proc = subprocess.run([sys.executable, "-c", _JAX_RING,
                           str(tmp / "jax_in.pkl"), str(tmp / "jax.pkl")],
                          capture_output=True, text=True, timeout=300,
                          env=env, cwd=str(torch_mesh.ROOT))
    assert proc.returncode == 0, proc.stderr[-3000:]
    with open(tmp / "jax.pkl", "rb") as f:
        ref = pickle.load(f)
    return cases, ranks, ref


# ---------------------------------------------------------------------------
# host prep
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n_dev,pad_factor,skew", [
    (4, 4.0, False), (8, 2.0, False), (4, 0.5, True), (1, 2.0, False)])
def test_bucket_edges_by_owner_equals_the_reference(n_dev, pad_factor, skew):
    """Array for array.  Eb is at least the largest bucket in both, so no
    edge overflows even where ``pad_factor`` alone would be too small (the
    skewed case: every edge from the first block)."""
    rng, ei = _graph()
    if skew:
        ei = ei[ei[:, 0] < N_PAD // n_dev]
    pos = rng.standard_normal((N, 3)).astype(np.float32)
    got = RD.bucket_edges_by_owner(N_PAD, ei, pos, n_dev, pad_factor)
    want = JRD.bucket_edges_by_owner(N_PAD, ei, pos, n_dev, pad_factor)
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]),
                                      np.asarray(want[k]), err_msg=k)
    assert got["overflow"] == 0
    with pytest.raises(ValueError):
        RD.bucket_edges_by_owner(N_PAD + 1, ei, pos, 4)


def test_pad_nodes_equals_the_reference():
    a = np.arange(12, dtype=np.float32).reshape(6, 2)
    np.testing.assert_array_equal(RD.pad_nodes(a, 8), JRD.pad_nodes(a, 8))


# ---------------------------------------------------------------------------
# one rank
# ---------------------------------------------------------------------------

def test_ring_on_one_rank(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    cases = _cases(1)
    plain = _plain(cases)
    with torch_mesh.one_rank_mesh(tmp_path):
        ring = init_device_mesh("cpu", (1, 1), mesh_dim_names=("data",
                                                               "model"))
        group, n, me = RD.ring_group(ring)
        toy = RD.ring_aggregate(
            lambda b: {"num": torch.full((3,), 7.0 + b)},
            {"num": torch.zeros(3)}, group, n, me)
        assert torch.equal(toy["num"], torch.full((3,), 7.0))
        for name, fn in (("eqv2", RD.eqv2_ring_loss),
                         ("sage", RD.sage_ring_loss)):
            cfg, params, batch = cases[name]
            l, g = value_and_grad(
                lambda p, b: fn(p, b, cfg, ring),
                tree.map_leaves(torch.from_numpy, params),
                {k: torch.as_tensor(v) for k, v in batch.items()})
            _close((float(l), [x.numpy() for x in tree.leaves(g)]),
                   plain[name], f"{name} one rank")


# ---------------------------------------------------------------------------
# four ranks
# ---------------------------------------------------------------------------

def test_ring_aggregate_on_four_ranks(four):
    _, ranks, _ = four
    for r in ranks:
        me = r["index"]
        np.testing.assert_array_equal(
            r["toy"]["num"], np.full(3, sum(100.0 * d + me for d in range(4))))
        np.testing.assert_array_equal(r["toy"]["den"], np.full(2, 6.0))


@pytest.mark.parametrize("name", ["eqv2", "sage"])
def test_ring_loss_on_four_ranks_equals_the_plain_loss(four, name):
    cases, ranks, _ = four
    want = _plain(cases)[name]
    for r in ranks:
        _close(r[name], want, f"{name} rank {r['index']}")


@pytest.mark.parametrize("name", ["eqv2", "sage"])
def test_ring_loss_on_four_ranks_equals_the_reference_ring(four, name):
    _, ranks, ref = four
    for r in ranks:
        _close(r[name], ref[name], f"{name} rank {r['index']}")


def test_ring_collectives_on_four_ranks(four):
    """One forward of the GraphSAGE ring: each of its 2 layers makes P + 1
    exchanges of one packed (num, den) block, W x (F + 1) float32 with F
    the layer's input width, and the loss sums its numerator and
    denominator over the ranks."""
    cases, ranks, _ = four
    cfg, _, batch = cases["sage"]
    W = N_PAD // 4
    want = sum(5 * W * (f + 1) * 4
               for f in (batch["node_feat"].shape[1], cfg.d_hidden))
    for r in ranks:
        a = r["analyze"]
        assert a["collective_counts"]["collective-permute"] == 2 * 5
        assert a["collective_bytes"]["collective-permute"] == want
        assert a["collective_counts"]["all-reduce"] == 2
        assert a["collective_counts"]["all-to-all"] == 0
        assert a["flops"] > 0
