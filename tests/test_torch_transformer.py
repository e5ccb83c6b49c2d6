"""The LM serving slice of the PyTorch port against ``repro``.

Reduced gemma3-4b (its window cut to 16 so that local layers mask), granite
8b and qwen2.5-14b (QKV bias): the JAX package's ``init_params(PRNGKey(0))``
carried across with ``interop.lm_params``, then ``forward``, ``prefill``
(flash kernel on, the JAX side in interpret mode, and off, which at a prompt
longer than ``attn_chunk`` takes the chunked and banded paths) and four
``decode_step``s compared in float32 at rtol = atol = 2e-5 (sums in other
orders through up to 13 layers; the largest difference seen is 3e-6).
Also: decode against forward inside the port
(``tests/test_arch_smoke.py::test_lm_decode_matches_forward``), greedy
serving against the JAX package's prefill-and-decode loop, and every config
field against the JAX config.
"""

import dataclasses
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduced import reduced_lm as jreduced_lm
from repro.models import transformer as JT
from repro_torch import interop
from repro_torch.configs import registry as tregistry
from repro_torch.configs.reduced import reduced_lm as treduced_lm
from repro_torch.kernels.flash_attention import ref as fref
from repro_torch.launch import serve as tserve
from repro_torch.models import transformer as TT

TOL = dict(rtol=2e-5, atol=2e-5)
DENSE = ["gemma3-4b", "granite-8b", "qwen2.5-14b"]
PROMPT = 128                 # > attn_chunk (64) of the reduced configs


def _configs(arch, **kw):
    """(JAX config, port config) of the reduced arch; gemma's window cut."""
    if arch == "gemma3-4b":
        kw.setdefault("window", 16)
    return (dataclasses.replace(jreduced_lm(jregistry.get_config(arch)), **kw),
            dataclasses.replace(treduced_lm(tregistry.get_config(arch)), **kw))


def _params(jcfg):
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    return jp, interop.lm_params(jax.tree.map(np.asarray, jp), device="cpu")


def _tokens(cfg, b, s, seed=0):
    return np.random.default_rng(seed).integers(0, cfg.vocab, (b, s)).astype(
        np.int32)


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


@pytest.mark.parametrize("arch", DENSE + ["phi3.5-moe-42b-a6.6b",
                                          "moonshot-v1-16b-a3b"])
def test_config_copies_jax_config(arch):
    """Every field of the port's config (the reference's less its Pallas
    tile size) equals the JAX config's, at full and at reduced size, and so
    do the parameter counts."""
    dtypes = {jnp.bfloat16: torch.bfloat16, jnp.float32: torch.float32}
    jfull, tfull = jregistry.get_config(arch), tregistry.get_config(arch)
    for jcfg, tcfg in ((jfull, tfull),
                       (jreduced_lm(jfull), treduced_lm(tfull))):
        for f in dataclasses.fields(TT.LMConfig):
            want = getattr(jcfg, f.name)
            want = dtypes.get(want, want) if f.name.endswith("dtype") else want
            assert getattr(tcfg, f.name) == want, (arch, f.name)
        assert tcfg.param_count() == jcfg.param_count()
        assert tcfg.active_param_count() == jcfg.active_param_count()


@pytest.mark.parametrize("arch", DENSE)
def test_forward_matches_jax(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    toks = _tokens(tcfg, 2, PROMPT)
    want, want_aux = jax.jit(partial(JT.forward, cfg=jcfg))(
        jp, jnp.asarray(toks))
    got, aux = TT.forward(tp, toks, tcfg, device="cpu")
    assert got.shape == (2, PROMPT, tcfg.vocab)
    np.testing.assert_allclose(_np(got.detach()), _np(want), **TOL)
    assert float(aux) == float(want_aux) == 0.0


@pytest.mark.parametrize("flash", [True, False], ids=["flash", "plain"])
@pytest.mark.parametrize("arch", DENSE)
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
    np.testing.assert_array_equal(_np(tcache["pos"]), _np(jcache["pos"]))
    jdecode = jax.jit(partial(JT.decode_step, cfg=jcfg))
    for i in range(PROMPT, PROMPT + 4):
        jcache, jl = jdecode(jp, jcache, jnp.asarray(toks[:, i]))
        tcache, tl = TT.decode_step(tp, tcache, toks[:, i], tcfg,
                                    device="cpu")
        np.testing.assert_allclose(_np(tl), _np(jl), **TOL)
    for key in ("k", "v", "pos"):
        np.testing.assert_allclose(_np(tcache[key]), _np(jcache[key]), **TOL)


def test_flash_route_reaches_the_op(monkeypatch):
    """With the flash flag, every prefill layer calls the flash op once;
    without it, none does."""
    from repro_torch.kernels.flash_attention import ops as fops

    calls = []

    def spy(q, k, v, *, causal, window):
        calls.append((tuple(q.shape), window))
        return fref.mha_reference(q, k, v, causal=causal, window=window)

    monkeypatch.setattr(fops, "flash_attention", spy)
    for flash in (True, False):
        _, tcfg = _configs("gemma3-4b", use_flash_kernel=flash)
        tp = TT.init_params(torch.Generator().manual_seed(0), tcfg)
        TT.prefill(tp, _tokens(tcfg, 1, PROMPT), tcfg, device="cpu")
    assert len(calls) == tcfg.n_layers
    assert [w for _, w in calls] == [
        16 if TT._kind(tcfg, i) == "local" else None
        for i in range(tcfg.n_layers)]


def test_decode_matches_forward():
    """tests/test_arch_smoke.py::test_lm_decode_matches_forward on the port,
    with a window that masks and a prompt past attn_chunk."""
    _, tcfg = _configs("gemma3-4b")
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    toks = _tokens(tcfg, 2, 3 * 64)
    with torch.no_grad():
        full, _ = TT.forward(tp, toks, tcfg, device="cpu")
    cache, last = TT.prefill(tp, toks[:, :PROMPT], tcfg, max_seq=PROMPT + 8,
                             device="cpu")
    np.testing.assert_allclose(_np(last), _np(full[:, PROMPT - 1]),
                               rtol=5e-4, atol=5e-4)
    for i in range(PROMPT, PROMPT + 4):
        cache, lg = TT.decode_step(tp, cache, toks[:, i], tcfg, device="cpu")
        np.testing.assert_allclose(_np(lg), _np(full[:, i]),
                                   rtol=5e-3, atol=5e-3)


def test_generate_matches_jax_serving_loop():
    """serve.generate against repro.launch.serve's loop (jit prefill, greedy
    decode) on the same carried-across parameters: same tokens."""
    jcfg, tcfg = _configs("gemma3-4b", use_flash_kernel=True)
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


@pytest.mark.parametrize("arch", tregistry.LM_ARCHS)
def test_pattern_periods_match_jax(arch):
    """``n_periods`` and ``n_remainder`` of every LM arch's full config
    equal the JAX config's."""
    jcfg, tcfg = jregistry.get_config(arch), tregistry.get_config(arch)
    assert (tcfg.n_periods, tcfg.n_remainder) == (jcfg.n_periods,
                                                  jcfg.n_remainder)
    assert tcfg.n_periods * len(tcfg.pattern) + tcfg.n_remainder \
        == tcfg.n_layers


@pytest.mark.parametrize("dtype", [None, torch.float32])
def test_init_cache_dtype_matches_jax(dtype, tmp_path):
    """``init_cache(dtype=)`` gives k and v in ``dtype`` (None: the
    config's compute dtype), as the JAX ``init_cache`` does, without a mesh
    and under a one-rank gloo ``use_mesh`` (``DTensor`` leaves)."""
    from repro_torch.models import common as cm
    from tests import torch_mesh

    jcfg, tcfg = _configs("gemma3-4b")
    want = JT.init_cache(jcfg, 2, 24, None if dtype is None else jnp.float32)
    got = TT.init_cache(tcfg, 2, 24, dtype, device="cpu")
    wdt = torch.float32 if dtype else tcfg.compute_dtype
    for k in ("k", "v", "pos"):
        assert tuple(got[k].shape) == want[k].shape
        assert got[k].dtype == (torch.int32 if k == "pos" else wdt)
        assert str(want[k].dtype) == str(got[k].dtype).split(".")[-1]
        assert not got[k].any()
    with torch_mesh.one_rank_mesh(tmp_path, (1, 1)) as mesh, \
            cm.use_mesh(mesh):
        placed = TT.init_cache(tcfg, 2, 24, dtype, device="cpu")
    for k in ("k", "v", "pos"):
        assert cm.is_dtensor(placed[k])
        assert placed[k].dtype == got[k].dtype
        assert tuple(placed[k].shape) == tuple(got[k].shape)
