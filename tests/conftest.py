"""Shared fixtures and graph factories for the test suite.

The factories were previously copy-pasted (with drift) across
``test_ooc_batch.py``, ``test_locality_ooc.py``, ``test_ooc_sharded.py``
and ``test_partitioner_fixes.py``; they are promoted here so every file —
and the cross-engine conformance matrix (``test_conformance.py``) — draws
from one corpus.  All factories are deterministic given their arguments
and return ``(n, canonical_edges)`` unless noted.
"""

import numpy as np
import pytest

from repro.core import graph as glib


@pytest.fixture
def rng():
    return np.random.default_rng(0)


def random_graph(rng, n, p):
    """Erdős–Rényi edge list (NOT canonicalized; the historical helper)."""
    mask = rng.random((n, n)) < p
    iu = np.triu_indices(n, 1)
    return np.stack(iu, 1)[mask[iu]]


def er_graph(rng, n=24, p=0.35):
    """Canonical Erdős–Rényi graph: ``(n, edges)``."""
    return n, glib.canonical_edges(random_graph(rng, n, p), n)


def rmat_graph(scale=5, edge_factor=6, seed=2):
    """Seeded power-law (R-MAT) graph — the paper's web/social shape at
    test size; mirrors ``benchmarks/datasets.py``."""
    from repro.data import graphgen

    n, edges = graphgen.rmat(scale, edge_factor, seed)
    return n, glib.canonical_edges(edges, n)


def star_hub_graph(n=64, hub_deg=40):
    """A hub star plus a sparse path tail: per-vertex NS costs are wildly
    uneven — the regime where cost-blind partitioning overflows bins."""
    hub = np.stack([np.zeros(hub_deg, np.int64),
                    np.arange(1, hub_deg + 1)], axis=1)
    tail = np.stack([np.arange(hub_deg + 1, n - 1),
                     np.arange(hub_deg + 2, n)], axis=1)
    return n, glib.canonical_edges(np.concatenate([hub, tail]), n)


def clique_edges(lo, size):
    """Edge list of a clique on vertices [lo, lo + size)."""
    iu = np.triu_indices(size, 1)
    return np.stack(iu, 1) + lo


def clustered_cliques(n_cliques=6, size=8, seed=7):
    """Disjoint cliques bridged into one component, vertex ids shuffled —
    contiguous-id blocks split every clique, locality growth recovers
    them."""
    n = n_cliques * size
    rng = np.random.default_rng(seed)
    perm = rng.permutation(n)
    blocks = [clique_edges(c * size, size) for c in range(n_cliques)]
    bridges = np.stack([np.arange(0, n - size, size),
                        np.arange(size, n, size)], axis=1)
    edges = perm[np.concatenate(blocks + [bridges])]
    return n, glib.canonical_edges(edges, n)


def disconnected_graph():
    """Three components with distinct k-classes (K6 ⊔ K4 ⊔ path) — the
    stage-2 k-jump and per-component trussness regime."""
    edges = np.concatenate([
        clique_edges(0, 6), clique_edges(6, 4),
        np.stack([np.arange(10, 14), np.arange(11, 15)], axis=1),
    ])
    return 15, glib.canonical_edges(edges, 15)


def triangle_free_graph(n=24):
    """A cycle plus chords to odd distance-3 vertices stays bipartite-ish
    enough to hold no triangle; every support is 0, phi is all 2."""
    cyc = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    chords = np.stack([np.arange(0, n - 3, 2),
                       np.arange(3, n, 2)], axis=1)
    return n, glib.canonical_edges(np.concatenate([cyc, chords]), n)


def conformance_corpus():
    """The shared (name, n, edges) corpus the conformance matrix and the
    per-file tests sweep: ER, power-law, skewed hub, clustered,
    disconnected and triangle-free shapes."""
    rng = np.random.default_rng(12)
    return [
        ("er", *er_graph(rng, 26, 0.3)),
        ("rmat", *rmat_graph(scale=5, edge_factor=6, seed=3)),
        ("star-hub", *star_hub_graph(40, 24)),
        ("clustered", *clustered_cliques(4, 6, seed=9)),
        ("disconnected", *disconnected_graph()),
        ("triangle-free", *triangle_free_graph(20)),
    ]


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "card: needs an NVIDIA card (a CUDA kernel with no CPU "
        "route); the test's fixture skips it without one")
