"""The port's arch registry and ``make_reduced`` over every arch of the
JAX package's registry (five LMs, four GNNs, DIN), as
``tests/test_arch_smoke.py`` runs the reference: one ``make_train_step``
step on the CPU from the reduced config's parameters and batch, then a
second on the next batch, with finite losses and parameters; the reduced
GNN and DIN batches equal the reference's array for array; and the
training CLI takes a GNN and the DIN arch."""

import dataclasses

import numpy as np
import pytest
import torch

from repro.configs import registry as jregistry
from repro.configs.reduced import make_reduced as jmake_reduced
from repro_torch import tree
from repro_torch.configs import registry as tregistry
from repro_torch.configs.cells import make_train_step
from repro_torch.configs.reduced import make_reduced
from repro_torch.launch import train as ttrain
from repro_torch.optim import adamw

OCFG = adamw.AdamWConfig(lr=1e-3, warmup_steps=2, total_steps=50)


def test_registry_lists_the_reference_archs():
    assert list(tregistry.ARCHS) == list(jregistry.ARCHS)
    assert tregistry.LM_ARCHS == jregistry.LM_ARCHS
    assert tregistry.GNN_ARCHS == jregistry.GNN_ARCHS
    assert tregistry.RECSYS_ARCHS == jregistry.RECSYS_ARCHS
    for arch in tregistry.ARCHS:
        assert type(tregistry.get_config(arch)).__name__ == \
            type(jregistry.get_config(arch)).__name__
    with pytest.raises(ValueError):
        tregistry.get_config("bert")


@pytest.mark.parametrize("arch", list(jregistry.ARCHS))
def test_reduced_train_step_is_finite(arch):
    cfg, init_fn, loss_fn, batch_fn = make_reduced(arch, device="cpu")
    params = init_fn()
    state = adamw.init_state(params)
    step = make_train_step(loss_fn, OCFG)
    params, state, m = step(params, state, batch_fn(0))
    assert np.isfinite(float(m["loss"])), (arch, m)
    for leaf in tree.leaves(params):
        assert torch.isfinite(leaf.float()).all(), arch
    params, state, m2 = step(params, state, batch_fn(1))
    assert np.isfinite(float(m2["loss"])), arch
    assert float(m2["loss"]) != float(m["loss"])


@pytest.mark.parametrize("arch", jregistry.GNN_ARCHS
                         + jregistry.RECSYS_ARCHS)
def test_reduced_batches_equal_the_reference(arch):
    jcfg = jmake_reduced(arch)[0]
    cfg, _, _, batch_fn = make_reduced(arch, device="cpu")
    assert dataclasses.asdict(cfg) == dataclasses.asdict(jcfg)
    jbatch = jmake_reduced(arch)[3]
    for step in (0, 3):
        want, got = jbatch(step), batch_fn(step)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]),
                                          err_msg=f"{arch} {k}")


@pytest.mark.parametrize("arch", ["gat-cora", "din"])
def test_train_cli_takes_a_gnn_and_din(arch, tmp_path, capsys):
    rows = ttrain.main(["--arch", arch, "--steps", "4", "--device", "cpu",
                        "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                        "--log-every", "1"])
    losses = [r["loss"] for r in rows if "loss" in r]
    assert len(losses) == 4 and all(np.isfinite(losses))
    assert f"[train] {arch}" in capsys.readouterr().out
