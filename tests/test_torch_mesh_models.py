"""The DIN and GNN cells' mesh paths on real values, against the JAX
package's unsharded results and the port's plain path.

Four gloo ranks (a (2, 2) ("data", "model") mesh, ``torch_mesh_cells``)
build the cells at reduced widths and small shapes: DIN's train, serve
and retrieval cells with ``recsys_family._build`` (the item table's rows
over "model", the batch and the candidates over "data"), and each GNN's
training cell as ``gnn_family`` builds its flat-graph cells (the edges
over every mesh axis, the nodes and parameters replicated:
``common.edge_sum``, ``gather``, ``rowwise`` and ``replicated``), with
EquiformerV2's tree batch as its ``minibatch_lg`` cell
(``eqv2_tree_loss``'s ``local_map`` over the data axes).  Their real
args are placed as ``DTensor``s by the cell's shardings, each step runs
under ``common.use_mesh`` and its outputs are gathered whole.

Held to the JAX package's jitted ``make_train_step``, ``din_scores`` and
``din_retrieval`` (EquiformerV2's trees: the reference's per-tree
``vmap``) on the same unsharded inputs, and to the port's same step
without a mesh, at ``torch_mesh_cells``' tolerances.  Also
``common.take`` on tables of 11 and 1 rows over the two "model" ranks
(blocks of 6 and 5 rows, and of 1 and none) equals the plain take
exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh_cells as M
from repro.configs import cells as jcells
from repro.configs import gnn_family as jgnn
from repro.configs import recsys_family as jrec
from repro.configs import registry as jregistry
from repro.configs.reduced import _gnn_batch as j_gnn_batch
from repro.configs.reduced import reduced_din as jreduced_din
from repro.configs.reduced import reduced_gnn as jreduced_gnn
from repro.data.recsys_stream import RecsysStream
from repro.models.gnn import models as JG
from repro.models.recsys import din as JD
from repro_torch.configs import cells as C
from repro_torch.configs import gnn_family, recsys_family
from repro_torch.configs import registry as tregistry
from repro_torch.configs.reduced import reduced_din, reduced_gnn
from repro_torch.models.gnn import models as TG
from repro_torch.models.recsys import din as TD

DIN = {"train": dict(kind="train", batch=16),
       "serve": dict(kind="serve", batch=16),
       "retrieval": dict(kind="retrieval", batch=1, n_candidates=200)}
GNN = {"meshgraphnet": (JG.mgn_loss, TG.mgn_init, TG.mgn_loss),
       "equiformer-v2": (JG.eqv2_loss, TG.eqv2_init, TG.eqv2_loss),
       "graphsage-reddit": (JG.sage_loss, TG.sage_init, TG.sage_loss),
       "gat-cora": (JG.gat_loss, TG.gat_init, TG.gat_loss)}
TAKE_IDS = np.array([[0, 10, 5], [6, 1, 10]], np.int32)
CASES = ([f"din/{k}" for k in DIN] + list(GNN)
         + ["equiformer-v2/trees", "take/V11", "take/V1"])


def _jstep(loss, ocfg, args):
    return jax.jit(jcells.make_train_step(loss, ocfg, 1))(
        *jax.tree.map(jnp.asarray, args))


def _trees(rng, B=4, nt=7):
    """EquiformerV2's tree batch: B subtrees of fanouts (2, 2)."""
    parent = np.array([0, 0, 1, 1, 2, 2])
    ei = np.broadcast_to(np.stack([np.arange(1, nt), parent], 1),
                         (B, nt - 1, 2)).astype(np.int32).copy()
    return {"node_feat": rng.standard_normal((B, nt, 8)).astype(np.float32),
            "positions": rng.standard_normal((B, nt, 3)).astype(np.float32),
            "edge_index": ei,
            "edge_mask": rng.random((B, nt - 1)) < 0.8,
            "targets": rng.standard_normal(B).astype(np.float32)}


def _jax_tree_loss(jcfg):
    """The reference's per-tree vmap of ``eqv2_forward``'s root."""
    def loss(p, b):
        def root(nf, pos, e, m):
            return JG.eqv2_forward(p, {"node_feat": nf, "positions": pos,
                                       "edge_index": e, "edge_mask": m},
                                   jcfg)[0, 0]
        out = jax.vmap(root)(b["node_feat"], b["positions"],
                             b["edge_index"], b["edge_mask"])
        return jnp.mean(jnp.square(out - b["targets"]))
    return loss


def _din_cases(payload, want):
    jcfg = jreduced_din(jregistry.get_config("din"))
    tcfg = reduced_din(tregistry.get_config("din"))
    hp = M.to_np(TD.din_init(torch.Generator().manual_seed(0), tcfg))
    jp, tp = jax.tree.map(jnp.asarray, hp), M.to_torch(hp)
    batch = RecsysStream(jcfg.n_items, jcfg.n_cats, jcfg.seq_len,
                         DIN["train"]["batch"], seed=0).batch(0)
    args = M.train_args(hp, batch)
    payload["din/train"] = ("din", tcfg, DIN["train"], args)
    want["din/train"] = (
        _jstep(lambda p, b: JD.din_loss(p, b, jcfg), jrec.OCFG, args),
        C.make_train_step(lambda p, b: TD.din_loss(p, b, tcfg),
                          recsys_family.OCFG, 1)(*M.to_torch(args)))
    serve = {k: v for k, v in batch.items() if k != "label"}
    payload["din/serve"] = ("din", tcfg, DIN["serve"], (hp, serve))
    with torch.no_grad():
        tres = TD.din_scores(tp, M.to_torch(serve), tcfg)
    want["din/serve"] = (JD.din_scores(jp, jax.tree.map(jnp.asarray, serve),
                                       jcfg), tres)
    rng = np.random.default_rng(2)
    n = DIN["retrieval"]["n_candidates"]
    retr = {"hist_items": batch["hist_items"][:1],
            "hist_cats": batch["hist_cats"][:1],
            "hist_mask": batch["hist_mask"][:1],
            "cand_items": rng.integers(0, jcfg.n_items, n, dtype=np.int32),
            "cand_cats": rng.integers(0, jcfg.n_cats, n, dtype=np.int32)}
    payload["din/retrieval"] = ("din", tcfg, DIN["retrieval"], (hp, retr))
    chunks = recsys_family.RETRIEVAL_CHUNKS
    with torch.no_grad():
        tres = TD.din_retrieval(tp, M.to_torch(retr), dataclasses.replace(
            tcfg, cand_chunks=chunks))
    want["din/retrieval"] = (JD.din_retrieval(
        jp, jax.tree.map(jnp.asarray, retr),
        dataclasses.replace(jcfg, cand_chunks=chunks)), tres)


def _gnn_cases(payload, want):
    for arch, (jloss, tinit, tloss) in GNN.items():
        jcfg = jreduced_gnn(jregistry.get_config(arch))
        tcfg = reduced_gnn(tregistry.get_config(arch))
        hp = M.to_np(tinit(torch.Generator().manual_seed(0), tcfg))
        cases = [(arch, {k: np.asarray(v)
                         for k, v in j_gnn_batch(arch).items()},
                  lambda p, b, jloss=jloss, jcfg=jcfg: jloss(p, b, jcfg),
                  lambda p, b, tloss=tloss, tcfg=tcfg: tloss(p, b, tcfg))]
        if arch == "equiformer-v2":
            cases.append((f"{arch}/trees", _trees(np.random.default_rng(3)),
                          _jax_tree_loss(jcfg),
                          lambda p, b, tcfg=tcfg:
                          gnn_family.eqv2_tree_loss(p, b, tcfg)))
        for name, batch, jl, tl in cases:
            args = M.train_args(hp, batch)
            payload[name] = ("gnn", arch, tcfg, args)
            want[name] = (_jstep(jl, jgnn.OCFG, args),
                          C.make_train_step(tl, gnn_family.OCFG, 1)(
                              *M.to_torch(args)))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload, want = {}, {}
    _din_cases(payload, want)
    _gnn_cases(payload, want)
    for V in (11, 1):
        ids = TAKE_IDS % V
        payload[f"take/V{V}"] = ("take", V, ids)
        table = torch.arange(V * 3, dtype=torch.float32).reshape(V, 3)
        want[f"take/V{V}"] = (None, table[torch.from_numpy(ids).long()])
    return M.run(payload, tmp_path_factory.mktemp("model_cells")), want


@pytest.mark.parametrize("case", CASES)
def test_cell_on_a_mesh_equals_the_reference_and_the_plain_port(case, runs):
    M.check(case, *runs)
