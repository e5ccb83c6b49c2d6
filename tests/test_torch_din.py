"""DIN and its embedding lookups in the PyTorch port against ``repro``.

DIN at ``reduced_din`` (5,000 items, 20 categories, the full widths): one
numpy parameter tree in the reference's layout (drawn by the port's init
from a generator seeded with 0; the layout is held to ``jax.eval_shape`` of
the reference's init) given to the JAX package as it is and to the port
through ``interop.param_tree``, and the reference's ``RecsysStream``
batches.  Lookups are gathers and sums of one row, so both routes
(``"take"`` and ``"bag"``, whose CPU version is the embedding bag's plain
version) equal ``jnp.take`` exactly.  Scores and the loss run matmuls and
sums in other orders on the two sides and are held at ``TOL``; gradients
at ``GRAD_TOL`` (the largest difference seen was 5.8e-7 of a leaf's
largest gradient).

Also: ``bce_with_logits``, ``din_retrieval`` against the reference's
chunked scan and against ``din_scores`` of the same pairs,
``RecsysStream`` array for array, ``param_count``, the route rule
(``kernel="bag"`` under a gradient raises), and ``sharded_lookup`` on a
one-rank gloo mesh in this process and on two gloo ranks
(``tests/torch_mesh.py``'s ``lookup`` suite), equal to the take exactly,
with an uneven V refused.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh
from repro.configs import recsys_family as jfam
from repro.configs import registry as jregistry
from repro.configs.reduced import reduced_din as jreduced_din
from repro.data.recsys_stream import RecsysStream as JStream
from repro.models import common as jcm
from repro.models.recsys import din as JD
from repro_torch import interop, tree
from repro_torch.configs import recsys_family as tfam
from repro_torch.configs import registry as tregistry
from repro_torch.configs.cells import value_and_grad
from repro_torch.configs.reduced import make_reduced, reduced_din
from repro_torch.data.recsys_stream import RecsysStream
from repro_torch.models import common as tcm
from repro_torch.models.recsys import din as TD
from repro_torch.models.recsys import embedding as temb

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_TOL = dict(rtol=1e-4, atol=1e-7)


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _host_params():
    cfg = reduced_din(tregistry.get_config("din"))
    return tree.map_leaves(lambda a: a.numpy(), TD.din_init(
        torch.Generator().manual_seed(0), cfg))


def _setup(batch=16, step=0):
    jcfg = jreduced_din(jregistry.get_config("din"))
    tcfg = reduced_din(tregistry.get_config("din"))
    hp = _host_params()
    jb = JStream(jcfg.n_items, jcfg.n_cats, jcfg.seq_len, batch,
                 seed=0).batch(step)
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, hp),
            interop.param_tree(hp, device="cpu"),
            {k: jnp.asarray(v) for k, v in jb.items()},
            {k: _t(v) for k, v in jb.items()})


def test_bce_with_logits_matches_jax():
    rng = np.random.default_rng(0)
    z = (4 * rng.standard_normal(64)).astype(np.float32)
    z[:4] = [40.0, -40.0, 0.0, 1e-3]
    y = (rng.random(64) < 0.5).astype(np.float32)
    want = float(jcm.bce_with_logits(jnp.asarray(z), jnp.asarray(y)))
    zt = _t(z).requires_grad_(True)
    got = tcm.bce_with_logits(zt, _t(y))
    np.testing.assert_allclose(float(got.detach()), want, **TOL)
    jg = jax.grad(lambda a: jcm.bce_with_logits(a, jnp.asarray(y)))(
        jnp.asarray(z))
    tg, = torch.autograd.grad(got, zt)
    np.testing.assert_allclose(tg.numpy(), np.asarray(jg), **TOL)
    assert tcm.bce_with_logits(_t(z).bfloat16(), _t(y)).dtype == \
        torch.float32


@pytest.mark.parametrize("kernel", [None, "take", "bag"])
def test_lookup_equals_the_take(kernel):
    jcfg, tcfg, jp, tp, jb, tb = _setup()
    want = np.asarray(JD._lookup(jp, jcfg, jb["hist_items"], jb["hist_cats"]))
    got = TD._lookup(tp, tcfg, tb["hist_items"], tb["hist_cats"], kernel)
    assert got.shape == (16, tcfg.seq_len, tcfg.embed_dim)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("kernel", ["take", "bag"])
def test_din_scores_match_jax(kernel):
    jcfg, tcfg, jp, tp, jb, tb = _setup()
    want = np.asarray(JD.din_scores(jp, jb, jcfg))
    with torch.no_grad():
        got = TD.din_scores(tp, tb, tcfg, kernel=kernel)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # no hist_mask: all ones, as in the reference
    nomask = {k: v for k, v in tb.items() if k != "hist_mask"}
    with torch.no_grad():
        assert torch.equal(TD.din_scores(tp, nomask, tcfg, kernel=kernel),
                           got)


def test_din_loss_and_grads_match_jax():
    jcfg, tcfg, jp, tp, jb, tb = _setup(batch=32, step=3)
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JD.din_loss(p, b, jcfg)))(jp, jb)
    tl, tg = value_and_grad(lambda p, b: TD.din_loss(p, b, tcfg), tp, tb)
    np.testing.assert_allclose(float(tl), float(jl), **TOL)
    want = jax.tree.leaves(jg)
    got = tree.leaves(tg)
    assert len(got) == len(want)
    for path, g, w in zip(tree.flatten_with_paths(tg)[0], got, want):
        w = np.asarray(w)
        np.testing.assert_allclose(
            g.numpy(), w, rtol=GRAD_TOL["rtol"],
            atol=GRAD_TOL["atol"] + 1e-6 * float(np.abs(w).max()),
            err_msg=path)


def _retrieval_batch(cfg, n=64):
    b = JStream(cfg.n_items, cfg.n_cats, cfg.seq_len, 4,
                seed=0).retrieval_batch(n, seed=2)
    return b


@pytest.mark.parametrize("kernel", ["take", "bag"])
def test_din_retrieval_matches_jax(kernel):
    jcfg, tcfg, jp, tp, _, _ = _setup()
    jcfg = dataclasses.replace(jcfg, cand_chunks=8)
    tcfg = dataclasses.replace(tcfg, cand_chunks=8)
    rb = _retrieval_batch(jcfg)
    want = np.asarray(JD.din_retrieval(
        jp, {k: jnp.asarray(v) for k, v in rb.items()}, jcfg))
    trb = {k: _t(v) for k, v in rb.items()}
    with torch.no_grad():
        got = TD.din_retrieval(tp, trb, tcfg, kernel=kernel)
    assert got.shape == (64,)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # the same (user, candidate) pairs through din_scores
    sb = {"hist_items": trb["hist_items"].expand(64, -1),
          "hist_cats": trb["hist_cats"].expand(64, -1),
          "hist_mask": trb["hist_mask"].expand(64, -1),
          "cand_item": trb["cand_items"], "cand_cat": trb["cand_cats"]}
    with torch.no_grad():
        np.testing.assert_allclose(
            got.numpy(), TD.din_scores(tp, sb, tcfg, kernel=kernel).numpy(),
            rtol=1e-5, atol=1e-5)
        with pytest.raises(ValueError):
            TD.din_retrieval(tp, trb, dataclasses.replace(
                tcfg, cand_chunks=7))


def test_lookup_route_rule():
    _, tcfg, _, tp, _, tb = _setup()
    ids, cats = tb["hist_items"], tb["hist_cats"]
    assert TD.lookup_route(tp) == "take"                 # CPU tables
    assert TD.lookup_route(tp, "bag") == "bag"           # no gradient
    with pytest.raises(ValueError):
        TD.lookup_route(tp, "gather")
    grad = dict(tp, item_emb=tp["item_emb"].clone().requires_grad_(True))
    assert TD.lookup_route(grad) == "take"
    with pytest.raises(ValueError, match="no backward"):
        TD._lookup(grad, tcfg, ids, cats, kernel="bag")
    with torch.no_grad():                                # no gradient here
        assert TD.lookup_route(grad, "bag") == "bag"
        TD._lookup(grad, tcfg, ids, cats, kernel="bag")
    # a train step differentiates through detached aliases: the take
    loss, _ = value_and_grad(lambda p, b: TD.din_loss(p, b, tcfg), tp, tb)
    assert np.isfinite(float(loss))
    with pytest.raises(ValueError, match="no backward"):
        value_and_grad(lambda p, b: TD.din_scores(p, b, tcfg,
                                                  kernel="bag").sum(), tp, tb)


@pytest.mark.parametrize("step,shard,n_shards", [(0, 0, 1), (5, 1, 2),
                                                 (17, 3, 4)])
def test_recsys_stream_matches_the_reference(step, shard, n_shards):
    args = (5000, 20, 100, 64)
    want = JStream(*args, seed=3).batch(step, shard, n_shards)
    got = RecsysStream(*args, seed=3).batch(step, shard, n_shards)
    assert set(got) == set(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    rw = JStream(*args, seed=3).retrieval_batch(1000, seed=4)
    rg = RecsysStream(*args, seed=3).retrieval_batch(1000, seed=4)
    for k in rw:
        np.testing.assert_array_equal(rg[k], rw[k], err_msg=k)


def test_param_count_and_layout_match_the_reference():
    full = tregistry.get_config("din")
    assert dataclasses.asdict(full) == \
        dataclasses.asdict(jregistry.get_config("din"))
    assert full.param_count() == jregistry.get_config("din").param_count() \
        == 180_054_282
    cfg = reduced_din(full)
    assert dataclasses.asdict(cfg) == \
        dataclasses.asdict(jreduced_din(jregistry.get_config("din")))
    params = make_reduced("din", device="cpu")[1]()
    assert sum(a.numel() for a in tree.leaves(params)) == cfg.param_count()
    want = jax.eval_shape(functools.partial(JD.din_init, cfg=cfg),
                          jax.random.PRNGKey(0))
    assert [tuple(a.shape) for a in tree.leaves(params)] == \
        [a.shape for a in jax.tree.leaves(want)]


def test_recsys_family_matches_the_reference():
    assert tfam.SHAPES == jfam.SHAPES
    assert dataclasses.asdict(tfam.OCFG) == dataclasses.asdict(jfam.OCFG)
    cfg = tregistry.get_config("din")
    for shape in jfam.SHAPES:
        assert tfam.model_flops(cfg, shape) == jfam.model_flops(
            jregistry.get_config("din"), shape)


def _lookup_inputs(V=24, seed=0):
    rng = np.random.default_rng(seed)
    table = rng.standard_normal((V, 5)).astype(np.float32)
    table[3] = -0.0
    ids = rng.integers(0, V, (7, 9)).astype(np.int32)
    ids[0, :3] = [0, V - 1, 3]
    return table, ids


def test_sharded_lookup_on_one_rank(tmp_path):
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.core import distributed as D

    table, ids = _lookup_inputs()
    want = table[ids]
    assert torch.equal(temb.sharded_lookup(_t(table), _t(ids)), _t(want))
    assert torch.equal(temb.take_baseline(_t(table), _t(ids)), _t(want))
    with torch_mesh.one_rank_mesh(tmp_path) as data:
        c0 = D.COLLECTIVES
        # a mesh without the axis: the take, no collective
        assert torch.equal(temb.sharded_lookup(_t(table), _t(ids), data),
                           _t(want))
        assert D.COLLECTIVES == c0
        model = init_device_mesh("cpu", (1,), mesh_dim_names=("model",))
        got = temb.sharded_lookup(_t(table), _t(ids), model)
        assert torch.equal(got, _t(want)) and D.COLLECTIVES == c0 + 1


def test_sharded_lookup_on_two_gloo_ranks(tmp_path):
    table, ids = _lookup_inputs(V=24)
    odd, _ = _lookup_inputs(V=25)
    ranks = torch_mesh.spawn("lookup", (2,), {"table": table, "ids": ids,
                                              "uneven": odd}, tmp_path,
                             timeout=120)
    want = table[ids]
    for r, out in enumerate(ranks):
        np.testing.assert_array_equal(out["model"], want, err_msg=str(r))
        np.testing.assert_array_equal(out["data"], want, err_msg=str(r))
        assert out["collectives"] == 1, out
        assert "divisible" in out["uneven"], out
