"""The drivers of the PyTorch port with a mesh, against ``repro``.

``bottom_up_decompose``, ``lower_bounding``, ``partitioned_support``,
``top_down_decompose`` (with and without a budget), ``truss_decompose``
with ``mesh_axes=`` and ``truss_maintain`` run on gloo ranks
(``tests/torch_mesh.py``) over a ("data",) mesh of 1 and of 2 ranks, on the
conformance corpus and a small R-MAT.  phi, the lower bounds and the
supports must equal the oracle and the reference's on every rank, and the
``OocStats`` counters both packages define alike must equal the JAX
package's mesh run at the same device count (a subprocess on forced host
devices, as ``tests/test_distributed.py`` runs it).  On two ranks the retry
ladders are driven across the mesh: the same injected plan on both ranks
reaches the mesh-drop rung with the reference's ``retries`` / ``degraded``;
an OOM on rank 1 alone (at a dispatch, at a finalize, raised by B1's
wrapper inside a round, or at a lane split's single-device sub-bucket) is
agreed on, so both ranks take the same rung and end equal; a journal
written by two ranks resumes on two and is refused on one, and a
time-gated one counts rank 0's snapshots on both.  ``tests/test_torch_mesh_wide.py`` runs the same checks on 4 ranks
and a (2, 2) mesh.
"""

import numpy as np
import pytest

from repro_torch.core import bottom_up as tbu
from tests import torch_mesh
from tests.torch_mesh import MESH_DROP_PLANS, STATS

SHAPES = [(1,), (2,)]
SHAPE_IDS = ["1", "2"]
ROWS = torch_mesh.graphs()
IDS = [r[0] for r in ROWS]
CALLS = [(name, call) for name, _, _, _, steps in ROWS
         for call in ("bu", "lb", "ps", "tdb", "td", "truss_decompose",
                      "maintain") if call != "maintain" or steps]
# each case's injected faults that fired on rank 0 and on rank 1
LADDER_CASES = {"rank 1 bottom-up dispatch": (0, 1),
                "rank 1 bottom-up finalize": (0, 1),
                "rank 1 top-down finalize": (0, 1),
                "rank 1 bottom-up B1 call 2": (0, 0),
                "rank 1 top-down B1 call 3": (0, 0),
                "rank 1 bottom-up retry 2 one lane": (1, 2)}


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The JAX package's runs (a subprocess) beside the port's ranks."""
    ref = torch_mesh.jax_mesh_run(SHAPES, single=True)
    payload = torch_mesh.drivers_payload()
    ranks = {shape: torch_mesh.spawn("drivers", shape, payload,
                                     tmp_path_factory.mktemp("drivers"))
             for shape in SHAPES}
    journal = tmp_path_factory.mktemp("journal")
    ladders = torch_mesh.spawn("ladders", (2,),
                               torch_mesh.ladders_payload(journal),
                               tmp_path_factory.mktemp("ladders"))
    return ranks, ladders, torch_mesh.jax_mesh_result(ref), journal


def check_drivers(runs, shape, name, call):
    """One driver's results on every rank of a mesh against the oracle,
    the JAX package's mesh run (corpus graphs) or one-device run."""
    ranks, ref = runs[0][shape], runs[2]
    oracle = torch_mesh.drivers_payload_oracle(name)
    n_dev = int(np.prod(shape))
    single = ref["single"][name]
    for res in ranks:
        out = res[name]
        if call in ("bu", "tdb", "td"):
            phi, st = out[call]
            np.testing.assert_array_equal(phi, oracle)
            assert st["devices"] == n_dev
            if name in ref[str(list(shape))]:
                want_phi, want = ref[str(list(shape))][name][call]
                np.testing.assert_array_equal(phi, want_phi)
                assert st == want, (call, shape, name)
        elif call == "lb":
            lb, phi, in_gnew, st = out["lb"]
            for got, want in zip((lb, phi, in_gnew), single["lb"]):
                np.testing.assert_array_equal(got, want)
            assert st["devices"] == n_dev
            assert st["rounds"] == out["bu"][1]["rounds"]
        elif call == "ps":
            sup, st = out["ps"]
            np.testing.assert_array_equal(sup, single["ps"][0])
            assert st["devices"] == n_dev
            assert {k: v for k, v in st.items() if k != "devices"} == \
                {k: v for k, v in single["ps"][1].items() if k != "devices"}
        elif call == "truss_decompose":
            phi, st = out[call]
            np.testing.assert_array_equal(phi, oracle)
            assert st["devices"] == n_dev and st["sharded_rounds"] >= 0
        elif call == "maintain":
            phi, st = out["maintain"]
            np.testing.assert_array_equal(phi, single["maintain"][0])
            for f in ("edits_applied", "maintain_levels", "affected_edges",
                      "rounds"):
                assert st[f] == single["maintain"][1][f], f
    # the replicated results are equal on every rank
    first = ranks[0][name][call]
    for res in ranks[1:]:
        for a, b in zip(res[name][call], first):
            if isinstance(b, dict):
                assert a == b
            else:
                np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name,call", CALLS,
                         ids=[f"{n}-{c}" for n, c in CALLS])
@pytest.mark.parametrize("shape", SHAPES, ids=SHAPE_IDS)
def test_driver_with_mesh(runs, shape, name, call):
    check_drivers(runs, shape, name, call)


@pytest.mark.parametrize("driver", sorted(MESH_DROP_PLANS))
def test_same_plan_takes_the_mesh_drop(runs, driver):
    """The same injected plan on both ranks exhausts the lane splits (or
    the level's retries) and drops the mesh: the reference's retries and
    degradations, phi equal to the oracle on both ranks."""
    _, ladders, ref, _ = runs
    want_phi, want, fired = ref["[2]"][f"same plan {driver}"]
    for res in ladders:
        phi, st, log = res[f"same plan {driver}"]
        np.testing.assert_array_equal(phi, want_phi)
        np.testing.assert_array_equal(
            phi, torch_mesh.drivers_payload_oracle(IDS[0]))
        assert (st["retries"], st["degraded"], log) == \
            (want["retries"], want["degraded"], fired)
        assert st["degraded"] >= 1
        assert {k: st[k] for k in STATS} == {k: want[k] for k in STATS}


@pytest.mark.parametrize("case", sorted(LADDER_CASES))
def test_one_rank_failure_is_agreed(runs, case):
    """A failure on rank 1 alone raises on both ranks, which take the same
    rung and end with equal phi and counters (no hang: the spawn has a
    timeout).  That holds for a dispatch that runs single-device inside a
    mesh run too (a lane-split sub-bucket of one lane)."""
    _, ladders, _, _ = runs
    (phi0, st0, log0), (phi1, st1, log1) = (r[case] for r in ladders)
    np.testing.assert_array_equal(phi0, torch_mesh.drivers_payload_oracle(
        IDS[0]))
    np.testing.assert_array_equal(phi1, phi0)
    assert st0 == st1 and st0["retries"] >= 1
    assert (log0, log1) == LADDER_CASES[case]
    if "retry 2" in case:
        assert (st0["retries"], st0["degraded"]) == (2, 0)


def test_time_gated_journal_follows_rank_0(runs):
    """A time-gated journal on two ranks whose clocks disagree: rank 0's
    clock decides, so both ranks count the same snapshots, and rank 0
    wrote them."""
    from repro_torch.checkpoint import manager as ckpt

    _, ladders, _, journal = runs
    want = ([False, True, False, True, False, True], 3, 3)
    assert [r["journal time gate"] for r in ladders] == [want, want]
    assert ckpt.all_steps(f"{journal}_time") == [1, 2, 3]


def test_journal_resumes_on_its_world_size_only(runs, tmp_path):
    """A journal written on two ranks resumes on two; a one-rank mesh (or
    none) refuses it, as the reference refuses another device count."""
    _, ladders, _, journal = runs
    for res in ladders:
        assert res["journal cut"]
        phi, st, resumed = res["journal resume"]
        np.testing.assert_array_equal(
            phi, torch_mesh.drivers_payload_oracle(IDS[0]))
        assert resumed >= 1 and st["devices"] == 2
    assert ladders[0]["journal resume"][2] == ladders[1]["journal resume"][2]
    p = torch_mesh.ladders_payload(journal)
    with torch_mesh.one_rank_mesh(tmp_path) as mesh:
        with pytest.raises(ValueError, match="different run"):
            tbu.bottom_up_decompose(p["n"], p["edges"], p["budget"],
                                    mesh=mesh, device="cpu",
                                    checkpoint_dir=str(journal), resume=True)
    with pytest.raises(ValueError, match="different run"):
        tbu.bottom_up_decompose(p["n"], p["edges"], p["budget"],
                                device="cpu", checkpoint_dir=str(journal),
                                resume=True)
