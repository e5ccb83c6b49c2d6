"""The optimizer, data and checkpoint pieces of the PyTorch port's
training slice against ``repro``.

AdamW: ``schedule`` (on a scalar tensor and on a Python number) and
``clip_by_global_norm`` against the reference's; five ``update`` steps
from one ``interop.adamw_state`` on every LM arch's reduced parameter tree
(and one bf16 tree) with the same seeded gradients: master, m, v and the
cast parameters held at ``TOL`` (the port's float32 ops round one at a
time, XLA's fused ones do not), the bf16 parameters at one bf16 step; the
update is in place (``make_train_step`` is in ``test_torch_train_step.py``).
Compression: ``quantize``,
``dequantize`` and ``ef_compress`` equal the reference's;
``compressed_psum`` on two gloo ranks (``tests/torch_mesh.py``) against the
reference's under ``shard_map`` on a two-device host mesh.
``TokenStream`` batches equal the reference's.
``checkpoint.manager.restore`` puts each tensor leaf on its ``like`` leaf's
device, or on the device ``shardings`` gives.
"""

import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import torch_mesh
from repro.configs import registry as jregistry
from repro.configs.reduced import reduced_lm as jreduced_lm
from repro.data.tokens import TokenStream as JTokenStream
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.optim import compression as jcomp
from repro_torch import interop, tree
from repro_torch.checkpoint import manager as ckpt
from repro_torch.configs import registry as tregistry
from repro_torch.configs.reduced import reduced_lm
from repro_torch.data.tokens import TokenStream
from repro_torch.optim import adamw
from repro_torch.optim import compression as tcomp

TOL = dict(rtol=2e-5, atol=2e-6)
LR = 1e-3
ARCHS = list(jregistry.LM_ARCHS)


def _configs(arch, **kw):
    return (dataclasses.replace(jreduced_lm(jregistry.get_config(arch)), **kw),
            dataclasses.replace(reduced_lm(tregistry.get_config(arch)), **kw))


@functools.lru_cache(maxsize=None)
def _host_params(jcfg):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                   jcfg))


def _params(jcfg):
    """The JAX package's ``init_params(PRNGKey(0))`` (drawn once a config)
    and the port's copy."""
    hp = _host_params(jcfg)
    return (jax.tree.map(jnp.asarray, hp),
            interop.lm_params(hp, device="cpu"))


def _assert_trees_close(got, want, **tol):
    paths, leaves = tree.flatten_with_paths(got)
    want = jax.tree.leaves(want)
    assert len(leaves) == len(want)
    for path, g, w in zip(paths, leaves, want):
        np.testing.assert_allclose(g.detach().float().numpy(),
                                   np.asarray(w, np.float32), err_msg=path,
                                   **tol)


# ------------------------------------------------------------------ AdamW

OCFGS = [dict(), dict(lr=1e-3, warmup_steps=1, total_steps=6),
         dict(lr=2e-2, warmup_steps=7, total_steps=50, min_lr_frac=0.0)]


@pytest.mark.parametrize("kw", OCFGS, ids=["default", "short", "long"])
def test_schedule_matches_jax(kw):
    jcfg, tcfg = jadamw.AdamWConfig(**kw), adamw.AdamWConfig(**kw)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    for step in [0, 1, 2, 5, 6, 7, 20, 49, 50, 99, 100, 101, 5000, 10_000,
                 20_000]:
        want = np.asarray(jadamw.schedule(jcfg, jnp.asarray(step, jnp.int32)))
        for arg in (torch.tensor(step, dtype=torch.int32), step,
                    float(step)):
            got = adamw.schedule(tcfg, arg)
            assert got.dtype == torch.float32
            np.testing.assert_allclose(got.numpy(), want, rtol=1e-6,
                                       err_msg=(step, type(arg)))


def _grad_tree(params, seed):
    rng = np.random.default_rng(seed)
    return jax.tree.map(
        lambda p: (rng.standard_normal(p.shape) * 0.05).astype(p.dtype),
        params)


def test_clip_by_global_norm_matches_jax():
    jcfg, _ = _configs("moonshot-v1-16b-a3b")
    shapes = jax.eval_shape(lambda k: JT.init_params(k, jcfg),
                            jax.random.PRNGKey(0))
    g = _grad_tree(shapes, 0)
    tg = interop.lm_params(g, device="cpu")
    for max_norm in (1.0, 1e3):
        jclipped, jn = jax.jit(jadamw.clip_by_global_norm,
                               static_argnums=1)(g, max_norm)
        clipped, n = adamw.clip_by_global_norm(tg, max_norm)
        np.testing.assert_allclose(float(n), float(jn), rtol=1e-6)
        _assert_trees_close(clipped, jclipped, rtol=1e-6, atol=0)
    assert float(n) < 1e3          # the second call leaves them unscaled
    for a, b in zip(tree.leaves(clipped), tree.leaves(tg)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("arch,dtype", [(a, "float32") for a in ARCHS]
                         + [("gemma3-4b", "bfloat16")])
def test_update_matches_jax(arch, dtype):
    """Five steps with the same seeded gradients from one state: lr,
    grad_norm, master, m, v and the cast parameters (a master near a
    rounding boundary may cast one bf16 step away: bf16 parameters are held
    at 2^-7 relative); every tensor updated in place."""
    jcfg, _ = _configs(arch, param_dtype=getattr(jnp, dtype))
    jp, tp = _params(jcfg)
    jstate = jadamw.init_state(jp)
    hp = _host_params(jcfg)
    tstate = interop.adamw_state(jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    ptrs = [x.data_ptr() for x in tree.leaves((tp, tstate["master"],
                                               tstate["m"], tstate["v"]))]
    ocfg = dict(lr=LR, warmup_steps=2, total_steps=20, clip_norm=0.5)
    jupdate = jax.jit(lambda p, s, g: jadamw.update(
        jadamw.AdamWConfig(**ocfg), p, s, g))
    for i in range(5):
        g = _grad_tree(hp, i)
        jp, jstate, jm = jupdate(jp, jstate, g)
        tp, tstate, tm = adamw.update(adamw.AdamWConfig(**ocfg), tp, tstate,
                                      interop.lm_params(g, device="cpu"))
        for k in ("lr", "grad_norm"):
            np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    assert int(tstate["step"]) == 5
    for k in ("master", "m", "v"):
        _assert_trees_close(tstate[k], jstate[k], **TOL)
    if dtype == "float32":
        _assert_trees_close(tp, jp, **TOL)
    else:
        for a, b in zip(tree.leaves(tp), jax.tree.leaves(jp)):
            assert a.dtype == torch.bfloat16
            np.testing.assert_allclose(a.float().numpy(),
                                       np.asarray(b, np.float32),
                                       rtol=2 ** -7, atol=1e-6)
    assert ptrs == [x.data_ptr() for x in tree.leaves(
        (tp, tstate["master"], tstate["m"], tstate["v"]))]


def test_weight_decay_mask():
    """The default mask decays the ndim >= 2 leaves alone; an explicit mask
    decides per leaf."""
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    zero = {"w": torch.zeros(2, 2), "b": torch.zeros(2)}
    cfg = adamw.AdamWConfig(lr=0.5, warmup_steps=1, weight_decay=0.1)
    _, st, _ = adamw.update(cfg, p, adamw.init_state(p), zero)
    assert float(st["master"]["b"][0]) == 1.0
    assert float(st["master"]["w"][0, 0]) < 1.0
    p = {"w": torch.ones(2, 2), "b": torch.ones(2)}
    _, st, _ = adamw.update(cfg, p, adamw.init_state(p), zero,
                            decay_mask={"w": False, "b": True})
    assert float(st["master"]["w"][0, 0]) == 1.0
    assert float(st["master"]["b"][0]) < 1.0


# ------------------------------------------------------------ compression

def _grads(seed, shape=(3, 257)):
    return (np.random.default_rng(seed).standard_normal(shape)
            * np.logspace(-3, 1, shape[-1])).astype(np.float32)


def test_quantize_and_ef_compress_match_jax():
    g, err = _grads(0), _grads(1) * 1e-3
    for x in (g, np.zeros_like(g), np.full_like(g, 0.5)):
        jq, js = jcomp.quantize(jnp.asarray(x))
        q, s = tcomp.quantize(torch.from_numpy(x))
        assert q.dtype == torch.int8
        np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
        assert float(s) == float(js)
        np.testing.assert_array_equal(tcomp.dequantize(q, s).numpy(),
                                      np.asarray(jcomp.dequantize(jq, js)))
    jq, js, je = jcomp.ef_compress(jnp.asarray(g), jnp.asarray(err))
    q, s, e = tcomp.ef_compress(torch.from_numpy(g), torch.from_numpy(err))
    np.testing.assert_array_equal(q.numpy(), np.asarray(jq))
    assert float(s) == float(js)
    np.testing.assert_array_equal(e.numpy(), np.asarray(je))


JAX_PSUM_SCRIPT = r"""
import json, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.optim.compression import compressed_psum
p = json.loads(sys.stdin.read())
mesh = jax.make_mesh((2,), ("data",))
fn = jax.jit(jax.shard_map(lambda g, e: compressed_psum(g, e, "data"),
                           mesh=mesh, in_specs=(P("data"), P("data")),
                           out_specs=(P("data"), P("data")),
                           check_vma=False))
err = jnp.asarray(np.array(p["error"], np.float32))
out = []
for g in p["grads"]:
    mean, err = fn(jnp.asarray(np.array(g, np.float32)), err)
    out.append([np.asarray(mean).tolist(), np.asarray(err).tolist()])
print(json.dumps(out))
"""


def test_compressed_psum_two_ranks_matches_jax(tmp_path):
    """Three steps carrying the error feedback, on two gloo ranks and on
    the reference's two-device shard_map: each rank's mean and new error
    equal the reference's shard (the mean within a quantization step of
    the exact mean)."""
    grads = [_grads(10 + i, (2, 257)) for i in range(3)]
    error = np.zeros((2, 257), np.float32)
    env = dict(os.environ, PYTHONPATH=str(torch_mesh.ROOT / "src"),
               JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=2")
    proc = subprocess.Popen(
        [sys.executable, "-c", JAX_PSUM_SCRIPT], env=env,
        stdin=subprocess.PIPE, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        text=True)
    ranks = torch_mesh.spawn("compress", (2,),
                             {"grads": grads, "error": error}, tmp_path,
                             timeout=120)
    so, se = proc.communicate(json.dumps(
        {"grads": [g.tolist() for g in grads], "error": error.tolist()}),
        timeout=120)
    assert proc.returncode == 0, se[-4000:]
    want = json.loads(so.strip().splitlines()[-1])
    for i, g in enumerate(grads):
        jmean, jerr = (np.array(a, np.float32) for a in want[i])
        # XLA contracts corrected - q * scale into one fused multiply-add:
        # the error may differ by an ulp of the product (|g| up to ~30)
        tol = dict(rtol=0.0, atol=4 * np.finfo(np.float32).eps
                   * float(np.abs(g).max()))
        for r in range(2):
            mean, err = ranks[r][i]
            np.testing.assert_allclose(mean, jmean[r], err_msg="mean", **tol)
            np.testing.assert_allclose(err, jerr[r], err_msg="error", **tol)
        np.testing.assert_array_equal(ranks[0][i][0], ranks[1][i][0])
    exact = grads[0].mean(0)
    scale = np.abs(grads[0]).max() / 127.0
    assert np.abs(ranks[0][0][0] - exact).max() <= scale


# ------------------------------------------------------------ token stream

@pytest.mark.parametrize("kw,calls", [
    (dict(vocab=211, seq_len=32, global_batch=4, seed=0),
     [(0, 0, 1), (1, 0, 1), (17, 0, 1)]),
    (dict(vocab=1000, seq_len=16, global_batch=8, seed=3, zipf_a=1.1),
     [(5, 0, 2), (5, 1, 2), (9, 3, 4)])])
def test_token_stream_matches_jax(kw, calls):
    a, b = JTokenStream(**kw), TokenStream(**kw)
    np.testing.assert_array_equal(a.perm, b.perm)
    for step, shard, n in calls:
        want, got = a.batch(step, shard, n), b.batch(step, shard, n)
        assert set(got) == {"tokens", "labels"}
        for k in got:
            assert got[k].dtype == np.int32
            np.testing.assert_array_equal(got[k], want[k])
        np.testing.assert_array_equal(got["tokens"][:, 1:],
                                      got["labels"][:, :-1])


# ------------------------------------------------- restore onto a device

def test_restore_puts_tensor_leaves_on_the_like_device(tmp_path):
    """Each tensor leaf comes back on its ``like`` leaf's device (``meta``
    stands in for the card here), in its dtype; the flat ``like=None`` form
    is unchanged; ``shardings`` places each leaf on the device it names,
    ``None`` leaving the ``like`` leaf's."""
    d = str(tmp_path)
    state = {"params": {"w": torch.arange(6.0).reshape(2, 3).to(
        torch.bfloat16)}, "opt": {"step": torch.tensor(3, dtype=torch.int32),
                                  "m": [torch.ones(3), np.zeros(2)]}}
    ckpt.save(d, 3, state, {"next_step": 3})
    like = {"params": {"w": torch.empty((2, 3), dtype=torch.bfloat16,
                                        device="meta")},
            "opt": {"step": torch.empty((), dtype=torch.int32, device="meta"),
                    "m": [torch.empty(3, device="meta"),
                          np.zeros(2, np.float32)]}}
    back, meta = ckpt.restore(d, like)
    assert meta == {"next_step": 3}
    for leaf in (back["params"]["w"], back["opt"]["step"],
                 back["opt"]["m"][0]):
        assert leaf.device.type == "meta"
    assert back["params"]["w"].dtype == torch.bfloat16
    assert isinstance(back["opt"]["m"][1], np.ndarray)
    flat, _ = ckpt.restore(d)
    assert set(flat) == {"params/w", "opt/step", "opt/m/0", "opt/m/1"}
    assert isinstance(flat["opt/m/0"], np.ndarray)
    cpu = torch.device("cpu")
    shardings = {"params": {"w": cpu}, "opt": {"step": None,
                                               "m": [cpu, cpu]}}
    back, _ = ckpt.restore(d, like, shardings=shardings)
    assert back["params"]["w"].device == cpu
    assert torch.equal(back["params"]["w"], state["params"]["w"])
    assert back["opt"]["step"].device.type == "meta"
    assert torch.equal(back["opt"]["m"][0], torch.ones(3))
    assert isinstance(back["opt"]["m"][1], torch.Tensor)
    with pytest.raises(ckpt.CheckpointStructureError, match="shardings"):
        ckpt.restore(d, like, shardings={"params": {"w": cpu}})
