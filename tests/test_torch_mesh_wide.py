"""The drivers of the PyTorch port on 4 gloo ranks, against ``repro``.

The checks of ``tests/test_torch_mesh_drivers.py`` on a ("data",) mesh of
4 ranks and on a (2, 2) ("data", "tri") mesh, where every bucket's lanes
split over "data", each lane's rows over "tri", and every level peel's rows
over both: phi, the lower bounds and the supports equal the oracle and the
reference's on every rank, and the shared ``OocStats`` counters equal the
JAX package's mesh run on the same number of forced host devices.
"""

import pytest

from tests import torch_mesh
from tests.test_torch_mesh_drivers import CALLS, check_drivers

SHAPES = [(4,), (2, 2)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's mesh runs (a subprocess) beside the port's
    ranks; the one-device results of the JAX package come along."""
    ref = torch_mesh.jax_mesh_run(SHAPES, single=True)
    payload = torch_mesh.drivers_payload()
    ranks = {shape: torch_mesh.spawn("drivers", shape, payload,
                                     tmp_path_factory.mktemp("drivers"))
             for shape in SHAPES}
    return ranks, None, torch_mesh.jax_mesh_result(ref)


@pytest.mark.parametrize("name,call", CALLS,
                         ids=[f"{n}-{c}" for n, c in CALLS])
@pytest.mark.parametrize("shape", SHAPES, ids=["4", "2x2"])
def test_driver_with_mesh(runs, shape, name, call):
    check_drivers(runs, shape, name, call)
