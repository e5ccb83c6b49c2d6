"""``make_train_step`` of the PyTorch port against
``repro.configs.cells.make_train_step``, at microbatches 1 and 2 for every
LM arch at ``reduced_lm`` in float32: one step from the JAX package's
``init_params(PRNGKey(0))`` and ``adamw.init_state``, carried across with
``interop.lm_params`` and ``interop.adamw_state``, on a ``TokenStream``
batch.  The loss, grad_norm, lr, m and v are held at ``TOL`` (sums in other
orders); after one AdamW step a parameter moves by ``lr * g / (|g| +
eps)``, which for a gradient near eps turns on its last bits, so the
parameters and master weights are held at ``STEP_TOL`` (a tenth of the
learning rate; 2.9e-5 seen).  Its own file, so that ``--dist loadfile``
runs it beside ``test_torch_train.py`` and ``test_torch_optim.py``.
"""

import jax
import numpy as np
import pytest
import torch

from repro.configs import cells as jcells
from repro.configs import registry as jregistry
from repro.configs.reduced import reduced_lm as jreduced_lm
from repro.models import transformer as JT
from repro.optim import adamw as jadamw
from repro_torch import interop, tree
from repro_torch.configs import registry as tregistry
from repro_torch.configs.cells import make_train_step
from repro_torch.configs.reduced import reduced_lm
from repro_torch.data.tokens import TokenStream
from repro_torch.models import transformer as TT
from repro_torch.optim import adamw

TOL = dict(rtol=2e-5, atol=2e-6)
LR = 1e-3
STEP_TOL = dict(rtol=0.0, atol=LR / 10)
ARCHS = list(jregistry.LM_ARCHS)


def _configs(arch):
    return (jreduced_lm(jregistry.get_config(arch)),
            reduced_lm(tregistry.get_config(arch)))


def _assert_trees_close(got, want, **tol):
    paths, leaves = tree.flatten_with_paths(got)
    want = jax.tree.leaves(want)
    assert len(leaves) == len(want)
    for path, g, w in zip(paths, leaves, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   err_msg=path, **tol)


@pytest.mark.parametrize("microbatches", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_matches_jax(arch, microbatches):
    """One step: loss, grad_norm, lr, the step count, m and v at ``TOL``,
    the master weights and parameters at ``STEP_TOL``."""
    jcfg, tcfg = _configs(arch)
    jp = JT.init_params(jax.random.PRNGKey(0), jcfg)
    tp = interop.lm_params(jax.tree.map(np.asarray, jp), device="cpu")
    ocfg = dict(lr=LR, warmup_steps=1, total_steps=10)
    jstate = jadamw.init_state(jp)
    tstate = interop.adamw_state(jax.tree.map(np.asarray, jstate),
                                 device="cpu")
    batch = TokenStream(jcfg.vocab, seq_len=32, global_batch=4,
                        seed=0).batch(3)
    jstep = jax.jit(jcells.make_train_step(
        lambda p, b: JT.loss_fn(p, b, jcfg)[0], jadamw.AdamWConfig(**ocfg),
        microbatches=microbatches))
    jp2, jstate2, jm = jstep(jp, jstate, batch)
    step = make_train_step(
        lambda p, b: TT.loss_fn(p, b, tcfg, device="cpu")[0],
        adamw.AdamWConfig(**ocfg), microbatches=microbatches)
    tp2, tstate2, tm = step(tp, tstate,
                            {k: torch.as_tensor(v) for k, v in batch.items()})
    for k in ("loss", "grad_norm", "lr"):
        np.testing.assert_allclose(float(tm[k]), float(jm[k]), **TOL)
    assert int(tstate2["step"]) == int(jstate2["step"]) == 1
    for k in ("m", "v"):
        _assert_trees_close(tstate2[k], jstate2[k], **TOL)
    _assert_trees_close(tstate2["master"], jstate2["master"], **STEP_TOL)
    _assert_trees_close(tp2, jp2, **STEP_TOL)
