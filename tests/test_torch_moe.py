"""The MoE serving slice of the PyTorch port against ``repro``.

Reduced moonshot-v1-16b-a3b (8 experts, top 6, 2 shared) and
phi3.5-moe-42b-a6.6b (8 experts, top 2, no shared): the JAX package's
``init_params(PRNGKey(0))`` carried across with ``interop.lm_params``.
``_moe_ffn`` takes the same normal input (numpy, seeded) on both sides and
is compared in ``out`` and ``aux`` at rtol = atol = 2e-5 in float32, with
the routing (experts, slots, kept slots) equal, at capacity factors 1.25,
0.5 (slots dropped in a prefill) and 8.0 (none dropped) and at a decode's
T = 2 (C = 1).  In bf16 the JAX function runs op by op, each op
rounding to bf16 where the reference's code says: under ``jax.jit`` XLA
fuses the elementwise chain (SwiGLU, the combine's weights and adds) and
skips those roundings, which moves ``out`` by up to 2^-6 from the same
function run op by op (|out| up to 2.4).  ``out`` is held at ``BF16_TOL``,
one bf16 step (2^-7 relative at the bottom of a binade; atol covers two
steps below 0.25), for matmuls that accumulate in another order; on this
input the two agree bit for bit.
Then ``forward``, ``prefill`` with four ``decode_step``s (flash and plain)
and greedy serving against the JAX package's loop, in float32 at 2e-5.
"""

import ast
import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduced import reduced_lm as jreduced_lm
from repro.models import common as jcm
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import registry as tregistry
from repro_torch.configs.reduced import reduced_lm as treduced_lm
from repro_torch.launch import serve as tserve
from repro_torch.models import common as tcm
from repro_torch.models import transformer as TT
from tests.test_torch_transformer import PROMPT, TOL, _np, _tokens

MOE = ["moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b"]
BF16_TOL = dict(rtol=2 ** -7, atol=2 ** -9)
BF16 = dict(jax=dict(param_dtype=jnp.bfloat16, compute_dtype=jnp.bfloat16),
            torch=dict(param_dtype=torch.bfloat16,
                       compute_dtype=torch.bfloat16))


def _configs(arch, dtype="float32", **kw):
    """(JAX config, port config) of the reduced MoE arch."""
    jkw = dict(kw, **BF16["jax"]) if dtype == "bf16" else kw
    tkw = dict(kw, **BF16["torch"]) if dtype == "bf16" else kw
    return (dataclasses.replace(jreduced_lm(jregistry.get_config(arch)), **jkw),
            dataclasses.replace(treduced_lm(tregistry.get_config(arch)),
                                **tkw))


def _params(jcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


def _layer(jp, tp, i=0):
    return (jax.tree.map(lambda a: a[i], jp["layers"]),
            {k: a[i] for k, a in tp["layers"].items()})


def _jax_routing(xt, router, cfg):
    """The routing lines of ``repro.models.transformer._moe_ffn``
    (``:329-342``), which keeps them inside the function: the JAX side of
    the routing comparison.  ``out`` of the real function checks that they
    agree with it."""
    T = xt.shape[0]
    E, K = cfg.n_experts, cfg.top_k
    C = max(1, int(cfg.capacity_factor * T * K / E))
    logits = xt.astype(jnp.float32) @ router.astype(jnp.float32)
    probs = jax.nn.softmax(logits, axis=-1)
    topw, tope = jax.lax.top_k(probs, K)
    topw = topw / jnp.maximum(topw.sum(-1, keepdims=True), 1e-9)
    fe = tope.reshape(-1)
    oh = jax.nn.one_hot(fe, E, dtype=jnp.int32)
    rank = (jnp.cumsum(oh, axis=0) - oh)[jnp.arange(T * K), fe]
    keep = rank < C
    slot = jnp.where(keep, fe * C + rank, E * C)
    return dict(C=C, topw=topw, tope=tope, slot=slot, keep=keep)


def _compare_moe_ffn(arch, b, s, dtype="float32", **kw):
    """Both ``_moe_ffn``s on the same (b, s, d) input and layer 0's tree;
    returns the port's routing."""
    jcfg, tcfg = _configs(arch, dtype, **kw)
    jp, tp = _params(jcfg)
    jl, tl = _layer(jp, tp)
    x = np.random.default_rng(7).standard_normal(
        (b, s, tcfg.d_model)).astype(np.float32)
    jx, tx = jnp.asarray(x, jcfg.compute_dtype), torch.from_numpy(x).to(
        tcfg.compute_dtype)
    jffn = partial(JT._moe_ffn, cfg=jcfg)
    jout, jaux = (jffn if dtype == "bf16" else jax.jit(jffn))(jx, jl)
    tout, taux = TT._moe_ffn(tx, tl, tcfg)
    assert tout.shape == (b, s, tcfg.d_model) and tout.dtype == tx.dtype
    tol = BF16_TOL if dtype == "bf16" else TOL
    np.testing.assert_allclose(tout.float().numpy(),
                               np.asarray(jout.astype(jnp.float32)), **tol)
    np.testing.assert_allclose(float(taux), float(jaux), **TOL)
    jh = jcm.rms_norm(jx, jl["ln2"], jcfg.norm_eps).reshape(b * s, -1)
    th = tcm.rms_norm(tx, tl["ln2"], tcfg.norm_eps).reshape(b * s, -1)
    want = _jax_routing(jh, jl["router"], jcfg)
    got = TT.moe_route(th, tl["router"], tcfg)
    assert got.capacity == want["C"]
    for key in ("tope", "slot", "keep"):
        np.testing.assert_array_equal(getattr(got, key).numpy(),
                                      np.asarray(want[key]), err_msg=key)
    np.testing.assert_allclose(got.topw.numpy(), np.asarray(want["topw"]),
                               **TOL)
    return got


@pytest.mark.parametrize("cf", [1.25, 0.5, 8.0])
@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_matches_jax(arch, cf):
    r = _compare_moe_ffn(arch, 2, PROMPT, capacity_factor=cf)
    dropped = int((~r.keep).sum())
    if cf == 0.5:
        assert dropped > 0
    if cf == 8.0:
        assert dropped == 0


@pytest.mark.parametrize("arch,b", [(MOE[0], 2), (MOE[1], 2), (MOE[1], 6)])
def test_moe_ffn_decode_size_matches_jax(arch, b):
    """A decode step of b requests: T = b, so C = 1 and the slots beyond an
    expert's first are dropped, as the reference drops them; with more
    slots than experts (moonshot's 12 at b = 2, phi3.5's 12 at b = 6) some
    must be."""
    r = _compare_moe_ffn(arch, b, 1)
    E, C = r.probs.shape[1], r.capacity
    assert C == 1
    forced = r.keep.numel() - E * C
    assert int((~r.keep).sum()) >= max(forced, 0)
    assert forced <= 0 or int((~r.keep).sum()) > 0


@pytest.mark.parametrize("arch", MOE)
def test_moe_ffn_bf16_matches_jax(arch):
    _compare_moe_ffn(arch, 2, PROMPT, dtype="bf16")


def test_moe_route_ranks_in_token_major_order():
    """The slot rank is the count of earlier slots (token-major, then k) to
    the same expert; slots past capacity go to the discarded row E*C."""
    _, tcfg = _configs(MOE[0], capacity_factor=0.5)
    xt = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (40, tcfg.d_model)).astype(np.float32))
    router = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (tcfg.d_model, tcfg.n_experts)).astype(np.float32))
    r = TT.moe_route(xt, router, tcfg)
    E, C = tcfg.n_experts, r.capacity
    seen = [0] * E
    for i, e in enumerate(r.tope.reshape(-1).tolist()):
        kept = seen[e] < C
        assert bool(r.keep[i]) == kept
        assert int(r.slot[i]) == (e * C + seen[e] if kept else E * C)
        seen[e] += 1
    np.testing.assert_allclose(r.topw.sum(-1).numpy(), 1.0, rtol=1e-6)


@pytest.mark.parametrize("arch", MOE)
def test_forward_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(tcfg, 2, PROMPT)
    want, want_aux = jax.jit(partial(JT.forward, cfg=jcfg))(
        jp, jnp.asarray(toks))
    got, aux = TT.forward(tp, toks, tcfg, device="cpu")
    assert got.shape == (2, PROMPT, tcfg.vocab)
    np.testing.assert_allclose(_np(got.detach()), _np(want), **TOL)
    np.testing.assert_allclose(float(aux), float(want_aux), **TOL)


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_jax(arch, flash):
    jcfg, tcfg = _configs(arch, use_flash_kernel=flash)
    jp, tp = _params(jcfg)
    toks = _tokens(tcfg, 2, PROMPT + 4)
    max_seq = PROMPT + 8
    jcache, jlast = jax.jit(partial(JT.prefill, cfg=jcfg, max_seq=max_seq))(
        jp, jnp.asarray(toks[:, :PROMPT]))
    tcache, tlast = TT.prefill(tp, toks[:, :PROMPT], tcfg, max_seq=max_seq,
                               device="cpu")
    np.testing.assert_allclose(_np(tlast), _np(jlast), **TOL)
    for key in ("k", "v"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **TOL)
    jdecode = jax.jit(partial(JT.decode_step, cfg=jcfg))
    for i in range(PROMPT, PROMPT + 4):
        jcache, jl = jdecode(jp, jcache, jnp.asarray(toks[:, i]))
        tcache, tl = TT.decode_step(tp, tcache, toks[:, i], tcfg,
                                    device="cpu")
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **TOL)


@pytest.mark.parametrize("arch", MOE)
def test_generate_matches_jax_serving_loop(arch):
    """serve.generate against repro.launch.serve's loop (jit prefill, greedy
    decode) on the same carried-across parameters: same tokens."""
    jcfg, tcfg = _configs(arch, use_flash_kernel=True)
    jp, tp = _params(jcfg)
    prompts = _tokens(tcfg, 4, PROMPT, seed=1)
    new, max_seq = 8, PROMPT + 8
    prefill = jax.jit(lambda p, t: JT.prefill(p, t, jcfg, max_seq=max_seq))
    decode = jax.jit(lambda p, c, t: JT.decode_step(p, c, t, jcfg))
    cache, logits = prefill(jp, jnp.asarray(prompts))
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    want = []
    for _ in range(new):
        want.append(np.asarray(tok))
        cache, logits = decode(jp, cache, tok)
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    gen = tserve.generate(tp, prompts, tcfg, new, max_seq, device="cpu")
    np.testing.assert_array_equal(gen.tokens, np.stack(want, 1))
    np.testing.assert_allclose(_np(gen.logits), _np(logits), **TOL)


@pytest.mark.parametrize("dtype", ["float32", "bf16"])
@pytest.mark.parametrize("arch", MOE)
def test_init_params_has_reference_layout(arch, dtype):
    """The port's init_params has the reference's keys, shapes and dtypes
    (``jax.eval_shape``; the router float32 in bf16 configs), and its element
    count is ``param_count()``; at full size the reference's shapes also
    count ``param_count()``."""
    jcfg, tcfg = _configs(arch, dtype)
    want = jax.eval_shape(partial(JT.init_params, cfg=jcfg),
                          jax.random.PRNGKey(0))
    got = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    dtypes = {jnp.dtype(jnp.bfloat16): torch.bfloat16,
              jnp.dtype(jnp.float32): torch.float32}
    flat_w = {"/".join(str(getattr(k, "key", k)) for k in path): leaf
              for path, leaf in jax.tree_util.tree_leaves_with_path(want)}
    flat_g = {f"layers/{k}": a for k, a in got["layers"].items()}
    flat_g.update({k: a for k, a in got.items() if k != "layers"})
    assert flat_g.keys() == flat_w.keys()
    for key, a in flat_g.items():
        assert tuple(a.shape) == flat_w[key].shape, key
        assert a.dtype == dtypes[flat_w[key].dtype], key
    assert got["layers"]["router"].dtype == torch.float32
    assert sum(a.numel() for a in flat_g.values()) == tcfg.param_count()
    full = jax.eval_shape(partial(JT.init_params,
                                  cfg=jregistry.get_config(arch)),
                          jax.random.PRNGKey(0))
    assert sum(int(np.prod(leaf.shape)) for leaf in jax.tree.leaves(full)) \
        == tregistry.get_config(arch).param_count()


@pytest.mark.parametrize("arch", MOE)
def test_lm_params_keeps_router_f32_and_expert_bits(arch):
    jcfg, _ = _configs(arch, "bf16")
    jp, tp = _params(jcfg)
    layers = tp["layers"]
    assert layers["router"].dtype == torch.float32
    np.testing.assert_array_equal(layers["router"].numpy(),
                                  np.asarray(jp["layers"]["router"]))
    experts = [k for k in layers if k.startswith(("we_", "ws_"))]
    assert len(experts) == (6 if jcfg.n_shared_experts else 3)
    for k in experts:
        assert layers[k].dtype == torch.bfloat16, k
        np.testing.assert_array_equal(
            layers[k].view(torch.int16).numpy(),
            np.asarray(jp["layers"][k]).view(np.int16), err_msg=k)


def test_serve_cli_moe(capsys):
    tserve.main(["--arch", "moonshot-v1-16b-a3b", "--device", "cpu",
                 "--requests", "2", "--prompt-len", "8", "--new-tokens",
                 "3"])
    out = capsys.readouterr().out
    assert "[serve] moonshot-v1-16b-a3b on cpu: 2 requests" in out
    line = [ln for ln in out.splitlines() if "first request generation" in ln]
    assert len(line) == 1
    assert len(ast.literal_eval(line[0].split(":", 1)[1].strip())) == 3
