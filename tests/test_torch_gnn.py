"""The GNN substrate of the PyTorch port against ``repro``.

The message-passing primitives (``segment_softmax``, ``aggregate`` in its
three modes, with masks and with a node that no edge reaches), ``mlp``,
``layer_norm``, ``sage_layer`` and ``gat_layer``, the Wigner rotations, and
each of the four archs at ``reduced_gnn``: one numpy parameter tree in the
reference's layout (drawn by the port's init from a generator seeded with
0; the layout is held to ``jax.eval_shape`` of the reference's init) given
to the JAX package as it is and to the port through
``interop.param_tree``, the same ``_gnn_batch`` arrays, then the forward,
the loss and every gradient against ``jax.value_and_grad`` (jitted).  The
two sides sum in other orders, so values are held at ``TOL`` and
gradients at ``GRAD_RTOL`` with an absolute floor of ``GRAD_ATOL`` times
the tree's largest gradient (the largest difference seen was 8.6e-5 of a
leaf's own largest gradient, on a leaf a thousand times smaller than the
tree's largest).

EquiformerV2 at the reduced depth of 2 gives its m > 0 SO(2) weights no
gradient (the input has scalars only, and the last block's l > 0 outputs
never reach the scalar readout), so it is also held at 3 layers, where
block 1's every weight has one.  Also: ``edge_chunks`` 1 and 4 give the
same loss, and the rotation-invariance check of
``tests/test_arch_smoke.py`` on the port.
"""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import gnn_family as jfam
from repro.configs import registry as jregistry
from repro.configs.reduced import _gnn_batch as j_gnn_batch
from repro.configs.reduced import reduced_gnn as jreduced_gnn
from repro.models import common as jcm
from repro.models.gnn import layers as JL
from repro.models.gnn import models as JG
from repro.models.gnn import wigner as JW
from repro_torch import interop, tree
from repro_torch.configs import gnn_family as tfam
from repro_torch.configs import registry as tregistry
from repro_torch.configs.cells import value_and_grad
from repro_torch.configs.reduced import _gnn_batch, make_reduced, reduced_gnn
from repro_torch.models import common as tcm
from repro_torch.models.gnn import layers as TL
from repro_torch.models.gnn import models as TG
from repro_torch.models.gnn import wigner as TW

TOL = dict(rtol=1e-5, atol=1e-6)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6
ARCHS = list(jregistry.GNN_ARCHS)
JAX_MODELS = {
    "meshgraphnet": (JG.mgn_init, JG.mgn_forward, JG.mgn_loss),
    "equiformer-v2": (JG.eqv2_init, JG.eqv2_forward, JG.eqv2_loss),
    "graphsage-reddit": (JG.sage_init, JG.sage_forward, JG.sage_loss),
    "gat-cora": (JG.gat_init, JG.gat_forward, JG.gat_loss),
}
PORT_MODELS = {
    "meshgraphnet": (TG.mgn_forward, TG.mgn_loss),
    "equiformer-v2": (TG.eqv2_forward, TG.eqv2_loss),
    "graphsage-reddit": (TG.sage_forward, TG.sage_loss),
    "gat-cora": (TG.gat_forward, TG.gat_loss),
}


def _t(a):
    return torch.from_numpy(np.array(a))


@functools.lru_cache(maxsize=None)
def _host_params(arch, tcfg):
    """A numpy tree in the reference's layout, from the port's init."""
    init = {"meshgraphnet": TG.mgn_init, "equiformer-v2": TG.eqv2_init,
            "graphsage-reddit": TG.sage_init, "gat-cora": TG.gat_init}[arch]
    return tree.map_leaves(lambda a: a.numpy(),
                           init(torch.Generator().manual_seed(0), tcfg))


def _setup(arch, **kw):
    """(jcfg, tcfg, JAX params, port params, JAX batch, port batch)."""
    jcfg = dataclasses.replace(jreduced_gnn(jregistry.get_config(arch)), **kw)
    tcfg = dataclasses.replace(reduced_gnn(tregistry.get_config(arch)), **kw)
    hp = _host_params(arch, tcfg)
    jb = j_gnn_batch(arch, seed=0)
    tb = _gnn_batch(arch, seed=0, device="cpu")
    return (jcfg, tcfg, jax.tree.map(jnp.asarray, hp),
            interop.param_tree(hp, device="cpu"), jb, tb)


def assert_grads_close(got, want, where):
    """Gradient trees, leaf by leaf, at GRAD_RTOL with an absolute floor of
    GRAD_ATOL times the largest gradient of the tree."""
    want = [np.asarray(w) for w in jax.tree.leaves(want)]
    got = tree.leaves(got)
    assert len(got) == len(want), where
    floor = GRAD_ATOL * max(float(np.abs(w).max()) for w in want)
    for path, g, w in zip(tree.flatten_with_paths(got)[0], got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=GRAD_RTOL, atol=floor,
                                   err_msg=f"{where}: {path}")


def _loss_and_grads(arch, jcfg, tcfg, jp, tp, jb, tb):
    """(JAX loss, grads, forward), then the port's loss and grads."""
    _, jfwd, jloss = JAX_MODELS[arch]
    (jl, out), jg = jax.jit(jax.value_and_grad(
        lambda p, b: (jloss(p, b, jcfg), jfwd(p, b, jcfg)), has_aux=True))(
            jp, jb)
    tloss = PORT_MODELS[arch][1]
    tl, tg = value_and_grad(lambda p, b: tloss(p, b, tcfg), tp, tb)
    return float(jl), jg, np.asarray(out), float(tl), tg


# ------------------------------------------------------------ primitives

def _segments(seed=0, E=60, n=12, H=None):
    """Scores or messages on E edges into n nodes; node n - 1 gets no
    edge, and a third of the edges are masked."""
    rng = np.random.default_rng(seed)
    seg = rng.integers(0, n - 1, E).astype(np.int32)
    shape = (E,) if H is None else (E, H)
    x = (3 * rng.standard_normal(shape)).astype(np.float32)
    mask = rng.random(E) < 0.67
    return x, seg, mask, n


@pytest.mark.parametrize("heads", [None, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_segment_softmax_matches_jax(heads, masked):
    x, seg, mask, n = _segments(H=heads)
    m = mask if masked else None
    if heads is None:
        want = JL.segment_softmax(jnp.asarray(x), jnp.asarray(seg), n,
                                  mask=None if m is None else jnp.asarray(m))
    else:      # the reference's per-head vmap (gat_layer, eqv2)
        want = jax.vmap(lambda s: JL.segment_softmax(
            s, jnp.asarray(seg), n, mask=None if m is None else
            jnp.asarray(m)), in_axes=1, out_axes=1)(jnp.asarray(x))
    got = TL.segment_softmax(_t(x), _t(seg), n,
                             mask=None if m is None else _t(m))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    if masked:
        assert (got.numpy()[~mask] == 0).all()


@pytest.mark.parametrize("masked", [False, True])
@pytest.mark.parametrize("agg", ["sum", "mean", "max"])
def test_aggregate_matches_jax(agg, masked):
    x, seg, mask, n = _segments(seed=1, H=5)
    m = mask if masked else None
    want = np.asarray(JL.aggregate(
        jnp.asarray(x), jnp.asarray(seg), n, agg=agg,
        mask=None if m is None else jnp.asarray(m)))
    got = TL.aggregate(_t(x), _t(seg), n, agg=agg,
                       mask=None if m is None else _t(m)).numpy()
    np.testing.assert_allclose(got, want, **TOL)
    # the node no edge reaches: 0 in every mode (max: -inf replaced by 0)
    assert (got[n - 1] == 0).all() and (want[n - 1] == 0).all()


def test_aggregate_rejects_an_unknown_mode():
    x, seg, _, n = _segments(H=2)
    with pytest.raises(ValueError):
        TL.aggregate(_t(x), _t(seg), n, agg="min")


@pytest.mark.parametrize("final_act", [False, True])
def test_mlp_matches_jax(final_act):
    dims = [7, 16, 9, 4]
    jp = jax.tree.map(np.asarray, JL.mlp_init(jax.random.PRNGKey(3), dims))
    x = np.random.default_rng(2).standard_normal((11, 7)).astype(np.float32)
    want = JL.mlp(jax.tree.map(jnp.asarray, jp), jnp.asarray(x),
                  final_act=final_act)
    got = TL.mlp(interop.param_tree(jp, device="cpu"), _t(x),
                 final_act=final_act)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    # the port's init: fan-in truncated normal, zero biases, the same shapes
    tp = TL.mlp_init(torch.Generator().manual_seed(0), dims)
    assert [tuple(a.shape) for a in tree.leaves(tp)] == \
        [a.shape for a in jax.tree.leaves(jp)]
    assert all((b == 0).all() for _, b in tp)


def test_layer_norm_matches_jax():
    rng = np.random.default_rng(4)
    x = (5 + 3 * rng.standard_normal((6, 32))).astype(np.float32)
    w, b = rng.standard_normal((2, 32)).astype(np.float32)
    want = jcm.layer_norm(jnp.asarray(x), jnp.asarray(w), jnp.asarray(b))
    got = tcm.layer_norm(_t(x), _t(w), _t(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    bf = tcm.layer_norm(_t(x).bfloat16(), _t(w), _t(b))
    assert bf.dtype == torch.bfloat16


def _layer_inputs(d_in=8, n=20, E=70, seed=5):
    rng = np.random.default_rng(seed)
    h = rng.standard_normal((n, d_in)).astype(np.float32)
    src = rng.integers(0, n, E).astype(np.int32)
    dst = rng.integers(0, n - 2, E).astype(np.int32)
    mask = rng.random(E) < 0.8
    return h, src, dst, mask, n


@pytest.mark.parametrize("agg", ["mean", "sum", "max"])
def test_sage_layer_matches_jax(agg):
    h, src, dst, mask, n = _layer_inputs()
    k1, k2 = jax.random.split(jax.random.PRNGKey(6))
    jp = {"w_self": np.asarray(jcm.dense_init(k1, (8, 12))),
          "w_nbr": np.asarray(jcm.dense_init(k2, (8, 12))),
          "b": np.linspace(-1, 1, 12).astype(np.float32)}
    want = JL.sage_layer(jax.tree.map(jnp.asarray, jp), jnp.asarray(h),
                         jnp.asarray(src), jnp.asarray(dst), n,
                         jnp.asarray(mask), agg=agg)
    got = TL.sage_layer(interop.param_tree(jp, device="cpu"), _t(h),
                        _t(src), _t(dst), n, _t(mask), agg=agg)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("final", [False, True])
def test_gat_layer_matches_jax(final):
    h, src, dst, mask, n = _layer_inputs(seed=7)
    H, Dh = 4, 3
    ks = jax.random.split(jax.random.PRNGKey(8), 3)
    jp = {"w": np.asarray(jcm.dense_init(ks[0], (8, H * Dh))),
          "a_src": np.asarray(jcm.dense_init(ks[1], (H, Dh))),
          "a_dst": np.asarray(jcm.dense_init(ks[2], (H, Dh)))}
    want = JL.gat_layer(jax.tree.map(jnp.asarray, jp), jnp.asarray(h),
                        jnp.asarray(src), jnp.asarray(dst), n, H, Dh,
                        jnp.asarray(mask), final=final)
    got = TL.gat_layer(interop.param_tree(jp, device="cpu"), _t(h), _t(src),
                       _t(dst), n, H, Dh, _t(mask), final=final)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


# ------------------------------------------------------------- rotations

def _directions(seed=9, k=40):
    """Random edge vectors, plus ones along +-z (the reference-axis switch)
    and nearly along z."""
    rng = np.random.default_rng(seed)
    d = rng.standard_normal((k, 3)).astype(np.float32)
    d[:4] = [[0, 0, 1], [0, 0, -2], [1e-3, 0, 1], [0.3, -0.2, 5]]
    return d


def test_rotation_to_z_matches_jax():
    d = _directions()
    want = np.asarray(JW.rotation_to_z(jnp.asarray(d)))
    got = TW.rotation_to_z(_t(d)).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)
    # rows orthonormal, and R d_hat = z_hat
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(3), got.shape),
                               atol=1e-5)
    dh = d / np.linalg.norm(d, axis=1, keepdims=True)
    np.testing.assert_allclose(np.einsum("kij,kj->ki", got, dh),
                               np.broadcast_to([0, 0, 1], dh.shape),
                               atol=1e-5)


@pytest.mark.parametrize("l_max", [0, 1, 2, 4, 6])
def test_wigner_stack_matches_jax(l_max):
    R = np.asarray(JW.rotation_to_z(jnp.asarray(_directions(seed=10))))
    want = np.asarray(JW.wigner_stack(jnp.asarray(R), l_max))
    got = TW.wigner_stack(_t(R), l_max).numpy()
    # float32 recursion in the same order; entries are at most 1
    np.testing.assert_allclose(got, want, rtol=0, atol=2e-6)
    # orthogonal: the real basis makes D^T D = I
    S = (l_max + 1) ** 2
    np.testing.assert_allclose(got @ got.transpose(0, 2, 1),
                               np.broadcast_to(np.eye(S), got.shape),
                               atol=1e-4)
    blocks = TW.wigner_blocks(_t(R), l_max)
    assert [tuple(b.shape[-2:]) for b in blocks] == \
        [(2 * l + 1, 2 * l + 1) for l in range(l_max + 1)]


# ----------------------------------------------------------------- archs

@pytest.mark.parametrize("arch", ARCHS)
def test_forward_loss_and_grads_match_jax(arch):
    jcfg, tcfg, jp, tp, jb, tb = _setup(arch)
    for k in jb:
        np.testing.assert_array_equal(tb[k].numpy(), np.asarray(jb[k]),
                                      err_msg=k)
    jl, jg, want, tl, tg = _loss_and_grads(arch, jcfg, tcfg, jp, tp, jb, tb)
    with torch.no_grad():
        got = PORT_MODELS[arch][0](tp, tb, tcfg).numpy()
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * float(np.abs(want).max()))
    np.testing.assert_allclose(tl, jl, **TOL)
    assert_grads_close(tg, jg, arch)


def test_equiformer_three_layers_reach_every_so2_weight():
    jcfg, tcfg, jp, tp, jb, tb = _setup("equiformer-v2", n_layers=3)
    jl, jg, _, tl, tg = _loss_and_grads("equiformer-v2", jcfg, tcfg, jp,
                                        tp, jb, tb)
    np.testing.assert_allclose(tl, jl, **TOL)
    assert_grads_close(tg, jg, "equiformer-v2, 3 layers")
    so2 = tg["blocks"][1]["so2"]
    assert set(so2) == {"wc_0", "wc_1", "wc_2", "ws_1", "ws_2"}
    assert all(float(g.abs().max()) > 0 for g in so2.values())


def test_equiformer_edge_chunks_give_the_same_loss():
    jcfg, tcfg, jp, tp, jb, tb = _setup("equiformer-v2", edge_chunks=4)
    assert tb["edge_index"].shape[0] % 4 == 0
    losses = []
    for chunks in (1, 4):
        cfg = dataclasses.replace(tcfg, edge_chunks=chunks)
        with torch.no_grad():
            losses.append(float(TG.eqv2_loss(tp, tb, cfg)))
    np.testing.assert_allclose(losses[1], losses[0], **TOL)
    jl = float(jax.jit(lambda p, b: JG.eqv2_loss(p, b, jcfg))(jp, jb))
    # (the reference's lax.scan over the chunks)
    np.testing.assert_allclose(losses[1], jl, **TOL)
    with pytest.raises(ValueError):
        TG.eqv2_loss(tp, tb, dataclasses.replace(tcfg, edge_chunks=3))


def test_equiformer_rotation_invariance():
    """``tests/test_arch_smoke.py``'s check on the port: rotating the
    positions leaves the output unchanged (the reference's tolerance)."""
    cfg, init_fn, _, batch_fn = make_reduced("equiformer-v2", device="cpu")
    params = init_fn()
    batch = batch_fn(0)
    rng = np.random.default_rng(1)
    q, r = np.linalg.qr(rng.standard_normal((3, 3)))
    R = q * np.sign(np.diag(r))
    if np.linalg.det(R) < 0:
        R[:, 0] = -R[:, 0]
    with torch.no_grad():
        out1 = TG.eqv2_forward(params, batch, cfg)
        out2 = TG.eqv2_forward(params, dict(
            batch, positions=batch["positions"] @ torch.as_tensor(
                R.T, dtype=torch.float32)), cfg)
    np.testing.assert_allclose(out1.numpy(), out2.numpy(), rtol=1e-3,
                               atol=1e-4)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_matches_the_reference_shapes(arch):
    jcfg = jreduced_gnn(jregistry.get_config(arch))
    tcfg = reduced_gnn(tregistry.get_config(arch))
    assert dataclasses.asdict(tcfg) == dataclasses.asdict(jcfg)
    want = jax.eval_shape(functools.partial(JAX_MODELS[arch][0], cfg=jcfg),
                          jax.random.PRNGKey(0))
    got = make_reduced(arch, device="cpu")[1]()
    assert [(tuple(a.shape), str(a.dtype)) for a in tree.leaves(got)] == \
        [(a.shape, f"torch.{a.dtype}") for a in jax.tree.leaves(want)]
    assert len(tree.flatten_with_paths(got)[0]) == len(jax.tree.leaves(want))


def test_gnn_family_matches_the_reference():
    assert tfam.SHAPES == jfam.SHAPES
    for shape in jfam.SHAPES:
        assert tfam._flat_sizes(shape) == jfam._flat_sizes(shape)
    assert tfam._pad_to(1000) == jfam._pad_to(1000) == 1024
    assert dataclasses.asdict(tfam.OCFG) == dataclasses.asdict(jfam.OCFG)
    cfgs = {a: (jregistry.get_config(a), tregistry.get_config(a))
            for a in ARCHS}
    n, e = jfam._flat_sizes("minibatch_lg")
    assert tfam.mgn_flops(cfgs["meshgraphnet"][1], n, e) == \
        jfam.mgn_flops(cfgs["meshgraphnet"][0], n, e)
    assert tfam.sage_flops(cfgs["graphsage-reddit"][1], n, e, 602) == \
        jfam.sage_flops(cfgs["graphsage-reddit"][0], n, e, 602)
    assert tfam.gat_flops(cfgs["gat-cora"][1], 2708, 21112, 1433, 7) == \
        jfam.gat_flops(cfgs["gat-cora"][0], 2708, 21112, 1433, 7)
    assert tfam.eqv2_flops(cfgs["equiformer-v2"][1], 3840, 16384) == \
        jfam.eqv2_flops(cfgs["equiformer-v2"][0], 3840, 16384)
    for a in ARCHS:
        assert dataclasses.asdict(cfgs[a][1]) == \
            dataclasses.asdict(cfgs[a][0])
