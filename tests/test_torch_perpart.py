"""The per-part seed baseline (``engine="perpart"``) of the port's
out-of-core drivers against ``repro.core.bottom_up``.

``lower_bounding``, ``bottom_up_decompose`` and ``partitioned_support``
with ``engine="perpart"`` must give the reference's ``lb``, ``in_gnew``,
phi, ``sup`` and its ``rounds``, ``scans`` and per-part counters on the
conformance corpus, with the sequential and the locality partitioner; phi
must equal the batched engine's too.  The engine keeps the reference's
``ValueError`` when combined with a mesh, a store or checkpointing.  The
port runs on the CPU.
"""

import contextlib
import warnings

import numpy as np
import pytest

from repro.core import bottom_up as jbu
from repro.core.partition import PartitionBudgetWarning
from repro.core.serial import alg2_truss
from repro_torch.core import bottom_up as tbu
from repro_torch.core import partition as tpart
from repro_torch.core.store import InMemoryStore
from tests.conftest import conformance_corpus

CORPUS = conformance_corpus()
IDS = [c[0] for c in CORPUS]
STATS = ("rounds", "scans", "parts", "batches", "max_part_edges",
         "real_edges", "padded_slots")


@contextlib.contextmanager
def _quiet():
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", PartitionBudgetWarning)
        warnings.simplefilter("ignore", tpart.PartitionBudgetWarning)
        yield


def _budget(ce):
    return max(8, len(ce) // 4)


@pytest.mark.parametrize("partitioner", ["sequential", "locality"])
@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_lower_bounding_perpart_equals_reference(name, n, ce, partitioner):
    with _quiet():
        j = jbu.lower_bounding(n, ce, _budget(ce), partitioner,
                               engine="perpart")
        t = tbu.lower_bounding(n, ce, _budget(ce), partitioner,
                               engine="perpart", device="cpu")
    for f in ("edges", "lb", "phi", "in_gnew"):
        np.testing.assert_array_equal(getattr(t, f), getattr(j, f),
                                      err_msg=f"{name} {f}")
    for f in STATS:
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)


@pytest.mark.parametrize("partitioner", ["sequential", "locality"])
@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_bottom_up_perpart_equals_reference(name, n, ce, partitioner):
    with _quiet():
        j = jbu.bottom_up_decompose(n, ce, _budget(ce), partitioner,
                                    engine="perpart")
        t = tbu.bottom_up_decompose(n, ce, _budget(ce), partitioner,
                                    engine="perpart", device="cpu")
        batched = tbu.bottom_up_decompose(n, ce, _budget(ce), partitioner,
                                          device="cpu")
    np.testing.assert_array_equal(t.phi, j.phi)
    np.testing.assert_array_equal(t.phi, alg2_truss(n, ce))
    np.testing.assert_array_equal(t.phi, batched.phi)
    assert (t.kmax, t.rounds, t.scans, t.candidate_sizes) == \
        (j.kmax, j.rounds, j.scans, j.candidate_sizes), name
    for f in STATS:
        assert getattr(t.stats, f) == getattr(j.stats, f), (name, f)


@pytest.mark.parametrize("partitioner", ["sequential", "locality"])
@pytest.mark.parametrize("name,n,ce", CORPUS, ids=IDS)
def test_partitioned_support_perpart_equals_reference(name, n, ce,
                                                      partitioner):
    with _quiet():
        jsup, js = jbu.partitioned_support(n, ce, _budget(ce), partitioner,
                                           engine="perpart", with_stats=True)
        tsup, ts = tbu.partitioned_support(n, ce, _budget(ce), partitioner,
                                           engine="perpart", with_stats=True)
        batched = tbu.partitioned_support(n, ce, _budget(ce), partitioner)
    np.testing.assert_array_equal(tsup, jsup)
    np.testing.assert_array_equal(tsup, batched)
    assert (ts.rounds, ts.scans) == (js.rounds, js.scans), name


def _perpart_calls(n, ce):
    """(label, call) pairs of every driver with engine="perpart"."""
    lb = lambda **kw: tbu.lower_bounding(n, ce, 16, engine="perpart",
                                         device="cpu", **kw)
    bu = lambda **kw: tbu.bottom_up_decompose(n, ce, 16, engine="perpart",
                                              device="cpu", **kw)
    ps = lambda **kw: tbu.partitioned_support(n, ce, 16, engine="perpart",
                                              **kw)
    return {"lower_bounding": lb, "bottom_up_decompose": bu,
            "partitioned_support": ps}


@pytest.mark.parametrize("driver", ["lower_bounding", "bottom_up_decompose",
                                    "partitioned_support"])
@pytest.mark.parametrize("what", ["mesh", "store", "checkpointing"])
def test_perpart_rejects_mesh_store_checkpointing(tmp_path, driver, what):
    from tests.torch_mesh import one_rank_mesh

    name, n, ce = CORPUS[0]
    call = _perpart_calls(n, ce)[driver]
    if what == "mesh":
        with one_rank_mesh(tmp_path) as mesh:
            with pytest.raises(ValueError, match="mesh= requires the batched"):
                call(mesh=mesh)
        return
    if what == "store":
        kw, match = dict(store=InMemoryStore()), "store= requires the batched"
    elif driver == "bottom_up_decompose":
        kw, match = dict(checkpoint_dir=str(tmp_path)), "checkpointing"
    else:
        kw, match = dict(restored=({}, {})), "checkpointing"
    with pytest.raises(ValueError, match=match):
        call(**kw)


@pytest.mark.parametrize("driver", ["lower_bounding", "bottom_up_decompose",
                                    "partitioned_support"])
def test_unknown_engine_and_batched_mesh(driver, tmp_path):
    """An unknown engine raises ``ValueError``, as in the reference; a mesh
    (a one-rank gloo mesh in this process) gives the reference's one-device
    result on the batched engine and ``ValueError`` on the per-part one."""
    from tests.torch_mesh import one_rank_mesh

    name, n, ce = CORPUS[0]
    fn, jfn = getattr(tbu, driver), getattr(jbu, driver)
    extra = {} if driver == "partitioned_support" else dict(device="cpu")
    with pytest.raises(ValueError, match="unknown engine"):
        fn(n, ce, 16, engine="pallas", **extra)
    with one_rank_mesh(tmp_path) as mesh:
        with _quiet():
            got, want = fn(n, ce, 16, mesh=mesh, **extra), jfn(n, ce, 16)
        for f in ("phi", "lb"):
            if hasattr(want, f):
                np.testing.assert_array_equal(getattr(got, f),
                                              getattr(want, f))
        if driver == "partitioned_support":
            np.testing.assert_array_equal(got, want)
        with pytest.raises(ValueError, match="mesh= requires"):
            fn(n, ce, 16, engine="perpart", mesh=mesh, **extra)
