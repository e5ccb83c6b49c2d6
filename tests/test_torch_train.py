"""The LM training slice of the PyTorch port against ``repro``.

Every LM arch at ``reduced_lm`` in float32: the JAX package's
``init_params(PRNGKey(0))`` carried across with ``interop.lm_params`` and
the reference's ``TokenStream`` batch, then ``loss_fn``'s loss, aux and
every gradient against the jitted ``jax.value_and_grad(loss_fn)`` (also at
128 tokens, through the chunked and banded attention).  Sums run in other
orders on the two sides (the largest gradient difference seen is 1.7e-6 on
gradients up to 0.07), so losses and gradients are held at ``TOL``.
``make_train_step`` against the reference's is in ``test_torch_optim.py``.

Also: remat on equals remat off exactly (both policies), the kill-and-resume
of ``train_loop.run``, a resume from the reference's checkpoint, the flash
kernel refused under a gradient, ``chunked_attention``'s positions,
``cross_entropy`` (with its mask) and ``finite_check``, and the training
CLI.
"""

import dataclasses
import functools
import os
import shutil
from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduced import make_reduced as jmake_reduced
from repro.configs.reduced import reduced_lm as jreduced_lm
from repro.models import attention as jatt
from repro.models import common as jcm
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro.runtime import train_loop as jloop
from repro_torch import interop, tree
from repro_torch.configs import registry as tregistry
from repro_torch.configs.cells import make_train_step, value_and_grad
from repro_torch.configs.reduced import make_reduced, reduced_lm
from repro_torch.data.tokens import TokenStream
from repro_torch.launch import train as ttrain
from repro_torch.models import attention as tatt
from repro_torch.models import common as tcm
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw
from repro_torch.runtime import train_loop

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
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=path, **tol)


def _grads(tcfg, tp, batch):
    """(total loss, {"loss", "aux"}, grads) of the port's loss_fn."""
    leaves = [p.detach().requires_grad_(True) for p in tree.leaves(tp)]
    total, parts = TT.loss_fn(tree.unflatten_like(tp, leaves), batch, tcfg,
                              device="cpu")
    grads = torch.autograd.grad(total, leaves)
    return (total.detach(), {k: v.detach() for k, v in parts.items()},
            tree.unflatten_like(tp, grads))


@pytest.mark.parametrize("arch", ARCHS)
def test_loss_and_grads_match_jax(arch):
    jcfg, tcfg = _configs(arch)
    jp, tp = _params(jcfg)
    batch = TokenStream(jcfg.vocab, seq_len=32, global_batch=4,
                        seed=0).batch(0)
    (jtotal, jparts), jg = jax.jit(jax.value_and_grad(
        partial(JT.loss_fn, cfg=jcfg), has_aux=True))(jp, batch)
    total, parts, grads = _grads(tcfg, tp, batch)
    for got, want in ((total, jtotal), (parts["loss"], jparts["loss"]),
                      (parts["aux"], jparts["aux"])):
        np.testing.assert_allclose(float(got), float(want), **TOL)
    assert (float(parts["aux"]) > 0) == jcfg.moe
    _assert_trees_close(grads, jg, **TOL)


@pytest.mark.parametrize("arch", ["gemma3-4b", "qwen2.5-14b"])
def test_grads_through_chunked_and_banded_attention(arch):
    """128 tokens, past the reduced attn_chunk (64): the global layers take
    chunked_attention and gemma's local layers (window 16)
    banded_attention, under a gradient (gemma cut to one pattern period,
    5 local layers and 1 global)."""
    kw = dict(window=16, n_layers=6) if arch == "gemma3-4b" else {}
    jcfg, tcfg = _configs(arch, **kw)
    jp, tp = _params(jcfg)
    batch = TokenStream(jcfg.vocab, seq_len=128, global_batch=2,
                        seed=1).batch(0)
    jtotal, jg = jax.jit(jax.value_and_grad(
        lambda p, b: JT.loss_fn(p, b, jcfg)[0]))(jp, batch)
    total, _, grads = _grads(tcfg, tp, batch)
    np.testing.assert_allclose(float(total), float(jtotal), **TOL)
    _assert_trees_close(grads, jg, **TOL)


@pytest.mark.parametrize("policy", ["full", "dots"])
@pytest.mark.parametrize("arch", ["gemma3-4b", "moonshot-v1-16b-a3b"])
def test_remat_equals_no_remat(arch, policy):
    """Recomputation changes no value: the loss and every gradient are
    equal bit for bit with and without remat, at 128 tokens (chunked and
    banded attention, the MoE dispatch)."""
    _, tcfg = _configs(arch, window=16)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    batch = TokenStream(tcfg.vocab, seq_len=128, global_batch=2,
                        seed=2).batch(0)
    runs = [_grads(dataclasses.replace(tcfg, **kw), tp, batch)
            for kw in (dict(remat=False),
                       dict(remat=True, remat_policy=policy))]
    (t0, p0, g0), (t1, p1, g1) = runs
    assert torch.equal(t0, t1) and torch.equal(p0["aux"], p1["aux"])
    for a, b in zip(tree.leaves(g0), tree.leaves(g1)):
        assert torch.equal(a, b)


def test_dots_policy_saves_the_unbatched_matmuls():
    """``remat_policy="dots"`` keeps mm/addmm outputs (the counterpart of
    dots_with_no_batch_dims_saveable) and recomputes the rest, bmm
    included."""
    from torch.utils.checkpoint import CheckpointPolicy

    aten = torch.ops.aten
    assert TT._dots_policy(None, aten.mm.default) == CheckpointPolicy.MUST_SAVE
    assert TT._dots_policy(None, aten.addmm.default) == \
        CheckpointPolicy.MUST_SAVE
    for op in (aten.bmm.default, aten.mul.Tensor, aten.exp.default):
        assert TT._dots_policy(None, op) == CheckpointPolicy.PREFER_RECOMPUTE


def _train_state(init_fn):
    params = init_fn()
    return {"params": params, "opt": adamw.init_state(params)}


def _train_fn(loss_fn, ocfg):
    step = make_train_step(loss_fn, ocfg)

    def train_step(state, batch):
        params, opt, m = step(state["params"], state["opt"], batch)
        return {"params": params, "opt": opt}, m

    return train_step


def _losses(rows):
    """{step: loss}, a replayed step's last row winning."""
    return {r["step"]: r["loss"] for r in rows if "loss" in r}


def test_train_loop_fault_resumes_to_the_same_losses(tmp_path):
    """A RuntimeError at step 7 restores step 4's checkpoint and replays:
    every step's loss equals the uninterrupted run's, and so do the final
    parameters."""
    _, init_fn, loss_fn, batch_fn = make_reduced("qwen2.5-14b", device="cpu")
    ocfg = adamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=12)
    runs = {}
    for name, hook in (("clean", None), ("fault", "once")):
        fired = []

        def fault_hook(step):
            if hook and step == 7 and not fired:
                fired.append(step)
                raise RuntimeError("injected step failure")

        lcfg = train_loop.LoopConfig(
            steps=12, ckpt_dir=str(tmp_path / name), ckpt_every=4,
            log_every=1, metrics_csv=str(tmp_path / f"{name}.csv"))
        runs[name] = train_loop.run(lcfg, lambda: _train_state(init_fn),
                                    _train_fn(loss_fn, ocfg), batch_fn,
                                    fault_hook=fault_hook)
    (clean, crows), (fault, frows) = runs["clean"], runs["fault"]
    assert [r for r in frows if "restart" in r] == [
        {"step": 4, "restart": 1, "error": "injected step failure"}]
    assert _losses(frows) == _losses(crows)
    assert sorted(_losses(crows)) == list(range(12))
    for a, b in zip(tree.leaves(fault), tree.leaves(clean)):
        assert torch.equal(a, b)
    header = open(tmp_path / "fault.csv").readline().strip().split(",")
    assert header == ["error", "grad_norm", "loss", "lr", "restart", "step",
                      "time"]


def test_resume_from_the_reference_checkpoint(tmp_path):
    """The reference's ``train_loop.run`` writes qwen2.5-14b's reduced
    checkpoints at steps 3 and 6; the port restores step 3 (the same
    on-disk layout and leaf paths) and runs steps 3-5, whose losses match
    the reference's."""
    arch = "qwen2.5-14b"
    jcfg, jinit, jloss, jbatch = jmake_reduced(arch)
    jocfg = jadamw.AdamWConfig(lr=LR, warmup_steps=1, total_steps=6)

    @jax.jit
    def jstep(state, batch):
        loss, grads = jax.value_and_grad(jloss)(state["params"], batch)
        params, opt, m = jadamw.update(jocfg, state["params"], state["opt"],
                                       grads)
        return {"params": params, "opt": opt}, {"loss": loss, **m}

    def jinit_state():
        params = jinit()
        return {"params": params, "opt": jadamw.init_state(params)}

    jdir = tmp_path / "jax"
    _, jrows = jloop.run(jloop.LoopConfig(steps=6, ckpt_dir=str(jdir),
                                          ckpt_every=3, log_every=1),
                         jinit_state, jstep, jbatch)
    shutil.copytree(jdir / "step_0000000003", tmp_path / "port" /
                    "step_0000000003")
    _, init_fn, loss_fn, batch_fn = make_reduced(arch, device="cpu")
    _, rows = train_loop.run(
        train_loop.LoopConfig(steps=6, ckpt_dir=str(tmp_path / "port"),
                              ckpt_every=3, log_every=1),
        lambda: _train_state(init_fn),
        _train_fn(loss_fn, adamw.AdamWConfig(lr=LR, warmup_steps=1,
                                             total_steps=6)), batch_fn)
    assert [r["step"] for r in rows] == [3, 4, 5]
    want = {r["step"]: r for r in jrows}
    for r in rows:
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(r[k], want[r["step"]][k], rtol=1e-5,
                                       err_msg=(r["step"], k))


def test_flash_kernel_refused_under_a_gradient():
    """The flash kernel has no backward (the reference's Pallas kernel has
    no reverse mode): under a gradient ``use_flash_kernel=True`` raises, so
    no gradient of wq/wk/wv is silently dropped; without one it runs."""
    _, tcfg = _configs("gemma3-4b", use_flash_kernel=True)
    tp = TT.init_params(torch.Generator().manual_seed(0), tcfg)
    batch = TokenStream(tcfg.vocab, seq_len=32, global_batch=2,
                        seed=0).batch(0)
    with pytest.raises(ValueError, match="reverse mode"):
        value_and_grad(lambda p, b: TT.loss_fn(p, b, tcfg, device="cpu")[0],
                       tp, batch)
    with torch.no_grad():
        logits, aux = TT.forward(tp, batch["tokens"], tcfg, device="cpu")
    plain, _ = TT.forward(tp, batch["tokens"], dataclasses.replace(
        tcfg, use_flash_kernel=False), device="cpu")
    assert not logits.requires_grad and float(aux) == 0.0
    np.testing.assert_allclose(logits.numpy(), plain.detach().numpy(),
                               rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("sq,skv,offset", [(64, 64, 0), (32, 96, 64),
                                           (32, 32, 5)])
def test_chunked_attention_positions_match_jax(sq, skv, offset):
    """``positions_q``/``positions_kv``: queries at ``offset + arange(sq)``
    against keys at ``arange(skv)`` (a suffix of queries over a longer
    history when skv > sq), against the reference."""
    rng = np.random.default_rng(sq + skv)
    q = rng.standard_normal((2, sq, 4, 16)).astype(np.float32)
    k = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    v = rng.standard_normal((2, skv, 2, 16)).astype(np.float32)
    pq = (offset + np.arange(sq)).astype(np.int32)
    pk = np.arange(skv, dtype=np.int32)
    want = jatt.chunked_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), q_chunk=16, k_chunk=32,
                                  positions_q=jnp.asarray(pq),
                                  positions_kv=jnp.asarray(pk))
    got = tatt.chunked_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), q_chunk=16, k_chunk=32,
                                 positions_q=torch.from_numpy(pq),
                                 positions_kv=pk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-5,
                               atol=2e-5)


def test_train_cli_trains_and_resumes_on_the_cpu(tmp_path, capsys,
                                                 monkeypatch):
    """``python -m repro_torch.launch.train --device cpu``: 8 steps, then a
    rerun to 10 that resumes from step 8's checkpoint; without
    ``--device`` it needs the card."""
    args = ["--arch", "granite-8b", "--device", "cpu", "--ckpt-dir",
            str(tmp_path), "--ckpt-every", "4", "--log-every", "1"]
    rows = ttrain.main(args + ["--steps", "8"])
    assert [r["step"] for r in rows] == list(range(8))
    assert all(np.isfinite(r["loss"]) for r in rows)
    assert os.path.isdir(tmp_path / "granite-8b" / "step_0000000008")
    rows = ttrain.main(args + ["--steps", "10"])
    assert [r["step"] for r in rows] == [8, 9]
    assert "[train] granite-8b" in capsys.readouterr().out
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        ttrain.main(["--arch", "granite-8b", "--steps", "1"])


@pytest.mark.parametrize("masked", [False, True])
def test_cross_entropy_matches_jax(masked):
    """Token-mean cross-entropy in float32 from bf16 and float32 logits,
    with and without a mask (one all-zero row: the masked mean divides by
    the mask's sum)."""
    rng = np.random.default_rng(5)
    logits = (rng.standard_normal((3, 7, 50)) * 4).astype(np.float32)
    labels = rng.integers(0, 50, (3, 7)).astype(np.int32)
    mask = (rng.random((3, 7)) < 0.6).astype(np.float32) if masked else None
    if masked:
        mask[1] = 0.0
    for dtype, jdtype in ((torch.float32, jnp.float32),
                          (torch.bfloat16, jnp.bfloat16)):
        want = jcm.cross_entropy(jnp.asarray(logits, jdtype),
                                 jnp.asarray(labels),
                                 None if mask is None else jnp.asarray(mask))
        got = tcm.cross_entropy(torch.from_numpy(logits).to(dtype),
                                torch.from_numpy(labels),
                                None if mask is None
                                else torch.from_numpy(mask))
        assert got.dtype == torch.float32
        np.testing.assert_allclose(float(got), float(want), rtol=1e-6)


def test_finite_check_matches_jax():
    """All-finite over a tree's floating leaves; integer leaves ignored."""
    base = {"a": np.ones((2, 3), np.float32), "b": [np.zeros(4, np.float32),
                                                    np.arange(3)],
            "c": {"d": np.full(2, 0.5, np.float32)}}
    for bad in (None, np.nan, np.inf, -np.inf):
        t = jax.tree.map(np.copy, base)
        if bad is not None:
            t["c"]["d"][1] = bad
        want = bool(jcm.finite_check(jax.tree.map(jnp.asarray, t)))
        got = tcm.finite_check(jax.tree.map(torch.from_numpy, t))
        assert got.dtype == torch.bool and bool(got) == want == (bad is None)
    assert bool(tcm.finite_check({"i": torch.arange(3)}))
