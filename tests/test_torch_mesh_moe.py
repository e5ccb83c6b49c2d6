"""The MoE LM cells' mesh paths on real values, against the JAX
package's unsharded results and the port's plain path.

As ``test_torch_mesh_lm.py``, for moonshot-v1-16b-a3b and
phi3.5-moe-42b-a6.6b at reduced widths: besides the dense layers' paths,
the MoE's routing, dispatch and combine run replicated around the
experts' matmuls, which are sharded over the experts, and the train
step's two microbatches are the reference's rows (an MoE layer's
capacity and load-balancing loss depend on which rows meet).  Held to the JAX package's jitted
``make_train_step``, ``prefill`` and ``decode_step`` on the same
unsharded inputs, and to the port's same step without a mesh, at
``torch_mesh_cells``' tolerances.
"""

import pytest

import torch_mesh_cells as M

ARCHS = ("moonshot-v1-16b-a3b", "phi3.5-moe-42b-a6.6b")


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    payload, want = M.lm_cases(ARCHS)
    return M.run(payload, tmp_path_factory.mktemp("moe_cells")), want


@pytest.mark.parametrize("case", M.lm_case_names(ARCHS))
def test_moe_cell_on_a_mesh_equals_the_reference_and_the_plain_port(case,
                                                                    runs):
    M.check(case, *runs)
