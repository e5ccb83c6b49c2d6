"""The serial oracles of the PyTorch port against ``repro.core.serial``.

``alg1_truss`` (the paper's Algorithm 1, Cohen's baseline) must equal the
JAX package's ``alg1_truss`` and the port's ``alg2_truss`` bit for bit, on
the conformance corpus and on seeded random graphs, with the supports
computed inside and handed in; ``initial_support``, ``truss_from_phi`` (at
every k) and ``verify_truss`` must equal the reference's.  All comparisons
are exact.
"""

import numpy as np
import pytest

from repro.core import graph as jgraph
from repro.core import serial as jserial
from repro.data import graphgen as jgen
from repro_torch.core import serial as tserial
from tests.conftest import conformance_corpus, random_graph


def _graphs():
    out = [(name, n, e) for name, n, e in conformance_corpus()]
    n, e = jgen.rmat(8, 6, seed=2)
    out.append(("rmat8", n, jgraph.canonical_edges(e, n)))
    rng = np.random.default_rng(0)
    for trial in range(10):
        n = int(rng.integers(5, 60))
        p = float(rng.uniform(0.05, 0.6))
        # not canonicalised: the oracles canonicalise their input
        out.append((f"random{trial}", n, random_graph(rng, n, p)))
    return out


GRAPHS = _graphs()
IDS = [name for name, _, _ in GRAPHS]


@pytest.mark.parametrize("name,n,edges", GRAPHS, ids=IDS)
def test_alg1_matches_reference_and_alg2(name, n, edges):
    got = tserial.alg1_truss(n, edges)
    want = jserial.alg1_truss(n, edges)
    assert got.dtype == want.dtype == np.int64
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tserial.alg2_truss(n, edges))
    np.testing.assert_array_equal(got, jserial.alg2_truss(n, edges))


@pytest.mark.parametrize("case", ["empty", "triangle-free", "clustered"])
def test_alg1_with_support_passed(case):
    if case == "empty":
        n, edges = 7, np.zeros((0, 2), np.int64)
        sup = np.zeros(0, np.int64)
    else:
        n, edges = ([(g[1], g[2]) for g in conformance_corpus()
                     if g[0] == case][0])
        sup = jserial.initial_support(n, edges)
    got = tserial.alg1_truss(n, edges, sup=sup)
    want = jserial.alg1_truss(n, edges, sup=sup)
    assert got.dtype == want.dtype == np.int64
    assert got.shape == want.shape == (len(edges),)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, tserial.alg1_truss(n, edges))
    np.testing.assert_array_equal(got, tserial.alg2_truss(n, edges, sup=sup))
    if case == "triangle-free":
        assert (got == 2).all()


@pytest.mark.parametrize("name,n,edges", GRAPHS[:7], ids=IDS[:7])
def test_initial_support_matches_reference(name, n, edges):
    got = tserial.initial_support(n, edges)
    want = jserial.initial_support(n, edges)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name,n,edges", GRAPHS[:7], ids=IDS[:7])
def test_truss_from_phi_matches_reference_at_every_k(name, n, edges):
    ce = jgraph.canonical_edges(edges, n)
    phi = tserial.alg2_truss(n, ce)
    for k in range(0, int(phi.max()) + 2):
        got = tserial.truss_from_phi(ce, phi, k)
        want = jserial.truss_from_phi(ce, phi, k)
        np.testing.assert_array_equal(got, want)
        assert len(got) == int((phi >= k).sum())


@pytest.mark.parametrize("name,n,edges", GRAPHS[:7], ids=IDS[:7])
def test_verify_truss_true_on_phi_false_with_a_class_raised(name, n, edges):
    phi = tserial.alg1_truss(n, edges)
    assert tserial.verify_truss(n, edges, phi)
    assert jserial.verify_truss(n, edges, phi)
    # the top class raised by one: the old k_max-truss would have to be a
    # (k_max + 1)-truss, which the maximality of the k_max-truss forbids
    bad = phi.copy()
    bad[phi == phi.max()] += 1
    assert not tserial.verify_truss(n, edges, bad)
    assert not jserial.verify_truss(n, edges, bad)


def test_verify_truss_empty_graph():
    e = np.zeros((0, 2), np.int64)
    phi = np.zeros(0, np.int64)
    assert tserial.verify_truss(4, e, phi) == jserial.verify_truss(4, e, phi)
