"""Shared parts of the tests that run the cells' mesh paths on real values
(``test_torch_mesh_lm.py``, ``test_torch_mesh_moe.py``,
``test_torch_mesh_models.py``; not a test module).

A test module builds a payload of cases (``lm_cases`` for the LM cells)
and, for each, the JAX package's result and the port's plain result on
the same unsharded inputs; ``run`` hands the payload to four gloo ranks
(``torch_mesh.py``'s ``cells`` suite, a (2, 2) ("data", "model") mesh),
and ``check`` holds rank 0's gathered outputs to both references and
every rank's to rank 0's.

Tolerances: a train step's loss and parameters at ``TOL`` (as
``test_torch_train.py``); logits, scores and caches at ``OUT_TOL`` (as
``test_torch_transformer.py``); a train step's grad norm at
``GRAD_RTOL``, and its AdamW moments, which hold the gradients (after one
step m = 0.1 g and v = 0.05 g^2), at ``GRAD_RTOL`` with an absolute
floor of ``GRAD_ATOL`` times the tree's largest.
"""

import numpy as np
import torch

import torch_mesh
from repro_torch import tree
from repro_torch.optim import adamw

MESH = (2, 2)
TOL = dict(rtol=2e-5, atol=2e-6)
OUT_TOL = dict(rtol=2e-5, atol=2e-5)
GRAD_RTOL, GRAD_ATOL = 1e-4, 1e-6


def to_np(t):
    """A tree of arrays (numpy, JAX or torch) as numpy arrays."""
    return tree.map_leaves(
        lambda a: a.detach().numpy() if isinstance(a, torch.Tensor)
        else np.array(a), t)


def to_torch(t):
    return tree.map_leaves(lambda a: torch.from_numpy(np.array(a)), t)


def train_args(params_np, batch_np):
    """(params, AdamW state, batch) of a train cell as numpy trees."""
    return (params_np, to_np(adamw.init_state(to_torch(params_np))),
            batch_np)


TRAIN = dict(kind="train", seq=32, batch=4)
PREFILL = dict(kind="prefill", seq=16, batch=4)
DECODE = dict(kind="decode", seq=24, batch=4)
LONG = dict(kind="decode", seq=24, batch=1, long=True)


def lm_case_names(archs) -> list:
    names = []
    for arch in archs:
        names += [f"{arch}/{k}" for k in ("train", "prefill", "decode")]
        if arch == "gemma3-4b":
            names.append(f"{arch}/long")
    return names


def lm_cases(archs):
    """The LM cells' cases of ``archs`` (``test_torch_mesh_lm.py``,
    ``test_torch_mesh_moe.py``; named by ``lm_case_names``): (payload,
    {case: (JAX result, plain port result)}).  Per arch: a train step of two
    microbatches with the cell's ZeRO-2 ``grad_specs``, a prefill of the
    whole sequence, a decode step from a cache of 24 positions holding
    16 (the port's plain prefill, given to both sides), and for
    gemma3-4b the long-context decode (batch 1, the cache's sequence over
    both axes)."""
    import jax

    from repro.configs import cells as jcells
    from repro.configs import lm_family as jfam
    from repro.configs import registry as jregistry
    from repro.configs.reduced import reduced_lm as jreduced_lm
    from repro.models import transformer as JT
    from repro_torch import interop
    from repro_torch.configs import cells as C
    from repro_torch.configs import lm_family
    from repro_torch.configs import registry as tregistry
    from repro_torch.configs.reduced import reduced_lm
    from repro_torch.data.tokens import TokenStream
    from repro_torch.models import transformer as TT

    payload, want = {}, {}
    rng = np.random.default_rng(1)
    for arch in archs:
        jcfg = jreduced_lm(jregistry.get_config(arch))
        tcfg = reduced_lm(tregistry.get_config(arch))
        hp = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0),
                                                     jcfg))
        jp = jax.tree.map(jax.numpy.asarray, hp)
        tp = to_np(interop.lm_params(hp, device="cpu"))

        batch = TokenStream(jcfg.vocab, seq_len=TRAIN["seq"],
                            global_batch=TRAIN["batch"], seed=0).batch(0)
        args = train_args(tp, batch)
        payload[f"{arch}/train"] = ("lm", tcfg, TRAIN, 2, args)
        jstep = jcells.make_train_step(
            lambda p, b: JT.loss_fn(p, b, jcfg)[0], jfam.OCFG, 2)
        tstep = C.make_train_step(
            lambda p, b: TT.loss_fn(p, b, tcfg, device="cpu")[0],
            lm_family.OCFG, 2)
        want[f"{arch}/train"] = (
            jax.jit(jstep)(*jax.tree.map(jax.numpy.asarray, args)),
            tstep(*to_torch(args)))

        toks = rng.integers(0, jcfg.vocab, (4, PREFILL["seq"] + 1),
                            dtype=np.int32)
        prompt = toks[:, :-1]
        payload[f"{arch}/prefill"] = ("lm", tcfg, PREFILL, 1, (tp, prompt))
        with torch.no_grad():
            tres = TT.prefill(to_torch(tp), torch.from_numpy(prompt), tcfg,
                              device="cpu")
        want[f"{arch}/prefill"] = (
            jax.jit(lambda p, t: JT.prefill(p, t, jcfg))(jp, prompt), tres)

        for name, sh in (("decode", DECODE), ("long", LONG)):
            if name == "long" and arch != "gemma3-4b":
                continue
            b = sh["batch"]
            with torch.no_grad():
                cache = to_np(TT.prefill(
                    to_torch(tp), torch.from_numpy(prompt[:b]), tcfg,
                    max_seq=sh["seq"], device="cpu")[0])
            tok = toks[:b, -1]
            payload[f"{arch}/{name}"] = ("lm", tcfg, sh, 1, (tp, cache, tok))
            with torch.no_grad():
                tres = TT.decode_step(to_torch(tp), to_torch(cache),
                                      torch.from_numpy(tok), tcfg,
                                      device="cpu")
            want[f"{arch}/{name}"] = (jax.jit(
                lambda p, c, t: JT.decode_step(p, c, t, jcfg))(
                    jp, jax.tree.map(jax.numpy.asarray, cache), tok), tres)
    return payload, want


def run(payload, tmp):
    """Every rank's gathered outputs, rank by rank."""
    return torch_mesh.spawn("cells", MESH, payload, tmp, timeout=600)


def _close(got, want, where, **tol):
    g, w = tree.leaves(got), tree.leaves(want)
    assert len(g) == len(w), where
    for i, (a, b) in enumerate(zip(g, w)):
        np.testing.assert_allclose(np.asarray(a, np.float32),
                                   np.asarray(b, np.float32),
                                   err_msg=f"{where} leaf {i}", **tol)


def _check_train(got, want, where):
    """A train step's (params, state, metrics) against a reference's."""
    params, state, metrics = got
    wparams, wstate, wmetrics = want
    np.testing.assert_allclose(float(metrics["loss"]),
                               float(wmetrics["loss"]), err_msg=where, **TOL)
    np.testing.assert_allclose(float(metrics["grad_norm"]),
                               float(wmetrics["grad_norm"]), rtol=GRAD_RTOL,
                               err_msg=where)
    for k in ("m", "v"):
        floor = GRAD_ATOL * max(float(np.abs(a).max())
                                for a in tree.leaves(wstate[k]))
        _close(state[k], wstate[k], f"{where} {k}", rtol=GRAD_RTOL,
               atol=floor)
    _close(params, wparams, f"{where} params", **TOL)


def check(case, ranks, want):
    """Rank 0's result of ``case`` against ``want[case]`` = (JAX result,
    plain port result); every rank's equal to rank 0's."""
    got = ranks[0][case]
    for r in ranks[1:]:
        for a, b in zip(tree.leaves(r[case]), tree.leaves(got)):
            np.testing.assert_array_equal(a, b, err_msg=f"{case}: ranks")
    for ref, name in zip(want[case], ("jax", "plain port")):
        if ref is None:
            continue
        ref = to_np(ref)
        where = f"{case} against the {name}"
        if isinstance(got, tuple) and len(got) == 3:
            _check_train(got, ref, where)
        else:
            _close(got, ref, where, **OUT_TOL)
