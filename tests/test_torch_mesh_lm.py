"""The dense LM cells' mesh paths on real values, against the JAX
package's unsharded results and the port's plain path.

Four gloo ranks (a (2, 2) ("data", "model") mesh) build the cells of
qwen2.5-14b, gemma3-4b and granite-8b at reduced widths with
``lm_family._build`` and small shapes (``torch_mesh_cells.lm_cases``:
a train step of two microbatches with the cell's ZeRO-2 ``grad_specs``,
a prefill, a decode step, and gemma3-4b's long-context decode).  Their
real args are placed as ``DTensor``s by the cell's shardings and each
step runs under ``common.use_mesh``: the token embedding as
``common.take``'s masked gather over a vocab of 211 rows split 106 / 105,
attention by ``local_map`` blocks, decode's one-hot write into a
sequence-sharded cache, the masked-sum cross-entropy and the microbatch
split of a sharded batch.  Held to the JAX package's jitted
``make_train_step``, ``prefill`` and ``decode_step`` on the same
unsharded inputs, and to the port's same step without a mesh, at
``torch_mesh_cells``' tolerances.
"""

import pytest

import torch_mesh_cells as M

ARCHS = ("qwen2.5-14b", "gemma3-4b", "granite-8b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload, want = M.lm_cases(ARCHS)
    return M.run(payload, tmp_path_factory.mktemp("lm_cells")), want


@pytest.mark.parametrize("case", M.lm_case_names(ARCHS))
def test_lm_cell_on_a_mesh_equals_the_reference_and_the_plain_port(case,
                                                                   runs):
    M.check(case, *runs)
