"""Fused frontier-peel round of the PyTorch port against ``repro``.

The port's round wrapper takes its plain version on CPU tensors; it is held
here against the JAX Pallas kernel in interpret mode and against the JAX
reference, over the shape sweep of ``test_fused_round_matches_ref``
(padding rows on the drop slot, rows with one corner on it).  The lockstep
loops are held against the JAX loops in phi, alive and stats; the JAX tile
``bt`` is chosen to divide T so neither side pads the triangle list.  All
comparisons are integer and exact.

The live-row round (``fused_round_live``: each lane reads its first
``n_rows`` rows and keeps the rows whose corners all survive) is held
against the JAX round on the same rows with everything past ``n_rows`` on
the drop slot, with padding rows in the middle of lanes, and the loops on
it against the JAX loops; the loops call it on every round that removes an
edge, also once no live row is left.
"""

import numpy as np
import pytest
import torch

from repro.core import graph as jgraph
from repro.core.support import list_triangles_np, support_from_triangle_list
from repro.kernels.frontier_peel import kernel as jfk
from repro.kernels.frontier_peel import ops as jops
from repro.kernels.frontier_peel import ref as jref
from repro_torch.kernels import check_kernel
from repro_torch.kernels.frontier_peel import kernel as tfk
from repro_torch.kernels.frontier_peel import ops as tops
from repro_torch.kernels.frontier_peel import ref as tref
from tests.conftest import random_graph

torch.manual_seed(0)


def _lane(rng, n, p, cap_e):
    """One padded lane (sup, alive, tris, m) on ``cap_e`` edge slots."""
    edges = jgraph.canonical_edges(random_graph(rng, n, p), n)
    m = len(edges)
    assert m <= cap_e
    tris = np.asarray(list_triangles_np(jgraph.build_graph(n, edges)),
                      np.int32).reshape(-1, 3)
    sup = np.zeros(cap_e, np.int32)
    sup[:m] = support_from_triangle_list(tris, m)
    alive = np.zeros(cap_e, np.int32)
    alive[:m] = 1
    return sup, alive, tris, m


def _pad_to(tris, t_cap, cap_e):
    out = np.full((t_cap, 3), cap_e, np.int32)
    out[: len(tris)] = tris
    return out


def _t(x):
    return torch.as_tensor(np.asarray(x, np.int32))


@pytest.mark.parametrize("cap_e,bt", [(64, 8), (64, 16), (128, 32),
                                      (256, 64), (256, 128)])
def test_fused_round_matches_jax(cap_e, bt):
    rng = np.random.default_rng(cap_e + bt)
    n0 = max(10, int((cap_e / 0.35) ** 0.5))
    for trial in range(2):
        sup, alive, tris, m = _lane(rng, n0 + trial, 0.35, cap_e)
        t_cap = max(bt, -(-max(len(tris), 1) // bt) * bt) + bt
        tris_p = _pad_to(tris, t_cap, cap_e)
        # a row with ONE corner on the drop slot must stay inert as well
        tris_p[-1] = [0, 1, cap_e]
        rm = ((sup <= 1) & (alive > 0)).astype(np.int32)
        rm[rng.integers(0, m, size=max(1, m // 8))] = 1
        rm &= alive
        args = (sup[None], alive[None], rm[None], tris_p[None])
        want = [jref.fused_round_ref(*args)]
        if trial == 0:          # the interpreted Pallas kernel is slow
            want.append(jfk.fused_round(*args, bt=bt, interpret=True))
        launches = tfk.LAUNCHES
        got = tfk.fused_round(*(_t(a) for a in args))
        assert tfk.LAUNCHES == launches      # CPU tensors: no kernel launch
        assert got[0].dtype == got[1].dtype == torch.int32
        for w in want:
            for g, x in zip(got, w):
                np.testing.assert_array_equal(g.numpy(), np.asarray(x))


def test_fused_round_multi_lane_matches_jax_ref():
    rng = np.random.default_rng(9)
    cap_e, B = 96, 4
    lanes = [_lane(rng, 14 + i, 0.4, cap_e) for i in range(B)]
    t_cap = max(len(t) for _, _, t, _ in lanes) + 3
    sup = np.stack([s for s, _, _, _ in lanes])
    alive = np.stack([a for _, a, _, _ in lanes])
    tris = np.stack([_pad_to(t, t_cap, cap_e) for _, _, t, _ in lanes])
    rm = alive * (rng.random(alive.shape) < 0.3).astype(np.int32)
    got = tfk.fused_round(_t(sup), _t(alive), _t(rm), _t(tris))
    want = jref.fused_round_ref(sup, alive, rm, tris)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_padding_rows_inert():
    rng = np.random.default_rng(5)
    cap_e = 64
    sup, alive, tris, _ = _lane(rng, 13, 0.4, cap_e)
    rm = ((sup <= 1) & (alive > 0)).astype(np.int32)
    lean = _pad_to(tris, len(tris), cap_e)
    fat = _pad_to(tris, len(tris) + 40, cap_e)
    a = tfk.fused_round(_t(sup[None]), _t(alive[None]), _t(rm[None]),
                        _t(lean[None]))
    b = tfk.fused_round(_t(sup[None]), _t(alive[None]), _t(rm[None]),
                        _t(fat[None]))
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def _batch(seed, cap_e, n_lanes, p=0.45):
    rng = np.random.default_rng(seed)
    n0 = max(9, int((cap_e / p) ** 0.5) - 2)
    lanes = [_lane(rng, n0 + i, p, cap_e) for i in range(n_lanes)]
    t_max = max(max(len(t) for _, _, t, _ in lanes), 1)
    t_max = -(-t_max // 8) * 8              # bt = 8 divides T: no padding
    sup = np.stack([s for s, _, _, _ in lanes])
    alive = np.stack([a for _, a, _, _ in lanes])
    tris = np.stack([_pad_to(t, t_max, cap_e) for _, _, t, _ in lanes])
    return sup, tris, alive


@pytest.mark.parametrize("cap_e,n_lanes", [(64, 2), (128, 1)])
def test_peel_classes_fused_matches_jax(cap_e, n_lanes):
    sup, tris, alive = _batch(17 + cap_e, cap_e, n_lanes)
    phi_j, st_j = jops.peel_classes_fused(sup, tris, alive, bt=8,
                                          interpret=True)
    phi_t, st_t = tops.peel_classes_fused(_t(sup), _t(tris), _t(alive))
    np.testing.assert_array_equal(phi_t.numpy(), np.asarray(phi_j))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    # and the plain host-loop peel of both packages
    np.testing.assert_array_equal(
        tref.peel_classes(_t(sup), _t(tris), _t(alive)).numpy(),
        np.asarray(jref.peel_classes_ref(sup, tris, alive)))


@pytest.mark.parametrize("thresh", [0, 2])
def test_peel_threshold_fused_matches_jax(thresh):
    rng = np.random.default_rng(23 + thresh)
    cap_e = 128
    sup, alive, tris, m = _lane(rng, 18, 0.4, cap_e)
    removable = np.zeros(cap_e, np.int32)
    removable[:m] = rng.integers(0, 2, m)
    alive[m - 3:m] = 0                       # some edges start dead
    tris_p = _pad_to(tris, -(-len(tris) // 8) * 8, cap_e)
    want = jops.peel_threshold_fused(sup, tris_p, removable, thresh, alive,
                                     bt=8, interpret=True)
    got = tops.peel_threshold_fused(_t(sup), _t(tris_p), _t(removable),
                                    thresh, _t(alive))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_stats_layout_matches_reference():
    assert tops.N_STATS == jops.N_STATS
    assert (tops._S_ROUNDS, tops._S_REMOVED, tops._S_GATHERED, tops._S_MAXF) \
        == (jops._S_ROUNDS, jops._S_REMOVED, jops._S_GATHERED, jops._S_MAXF)


def test_wrapper_validates_inputs():
    sup = torch.zeros((2, 8), dtype=torch.int32)
    tris = torch.full((2, 4, 3), 8, dtype=torch.int32)
    with pytest.raises(TypeError):
        tfk.fused_round(sup.long(), sup, sup, tris)
    with pytest.raises(ValueError):
        tfk.fused_round(sup, sup[:1], sup, tris)
    with pytest.raises(ValueError):
        tfk.fused_round(sup, sup, sup, tris[:1])
    with pytest.raises(ValueError):
        check_kernel("pallas")
    with pytest.raises(ValueError):
        tops.peel_classes_fused(sup, tris, sup, kernel="xla")


def _live_case(seed, B, cap_e, n_cut):
    """B lanes with padding rows in the middle and at the end, an rm mask,
    and n_rows that cut ``n_cut`` real rows off the end of each lane."""
    rng = np.random.default_rng(seed)
    lanes = [_lane(rng, 12 + 2 * i, 0.45, cap_e) for i in range(B)]
    t_max = max(len(t) for _, _, t, _ in lanes)
    T = t_max + 9
    tris = np.full((B, T, 3), cap_e, np.int32)
    n_rows = np.zeros(B, np.int32)
    for b, (_, _, t, _) in enumerate(lanes):
        mid = len(t) // 2           # four padding rows in the middle
        tris[b, :mid] = t[:mid]
        tris[b, mid + 4: len(t) + 4] = t[mid:]
        tris[b, mid + 1, 0] = 1      # a row with one corner on the drop slot
        n_rows[b] = max(len(t) + 4 - n_cut * (b % 2), 0)
    sup = np.stack([s_ for s_, _, _, _ in lanes])
    alive = np.stack([a for _, a, _, _ in lanes])
    alive[:, ::11] = 0                     # some corners dead at entry
    rm = alive * (rng.random(alive.shape) < 0.25).astype(np.int32)
    return sup, alive, rm, tris, n_rows


@pytest.mark.parametrize("B,cap_e,n_cut", [(1, 64, 0), (1, 96, 3),
                                           (3, 96, 0), (4, 128, 5)])
def test_fused_round_live_matches_jax(B, cap_e, n_cut):
    sup, alive, rm, tris, n_rows = _live_case(B * cap_e + n_cut, B, cap_e,
                                              n_cut)
    T = tris.shape[1]
    # what the lane reads: rows past n_rows are padding
    read = np.where((np.arange(T)[None, :] < n_rows[:, None])[:, :, None],
                    tris, cap_e).astype(np.int32)
    want = jref.fused_round_ref(sup, alive, rm, read)
    tris_out = torch.full((B, T, 3), -1, dtype=torch.int32)
    n_out = torch.full((B,), -1, dtype=torch.int32)
    launches = tfk.LAUNCHES
    got = tfk.fused_round_live(_t(sup), _t(alive), _t(rm), _t(tris),
                               _t(n_rows), tris_out, n_out)
    assert tfk.LAUNCHES == launches          # CPU tensors: no kernel launch
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    # the kept rows: exactly the rows read whose corners all survive, in
    # their input order, the drop slot after them
    alive2 = np.asarray(want[1])
    for b in range(B):
        r = read[b]
        ok = (r < cap_e).all(axis=1)
        ok[ok] = (alive2[b][r[ok]] > 0).all(axis=1)
        kept = r[ok]
        assert n_out[b] == len(kept)
        np.testing.assert_array_equal(tris_out[b, :len(kept)].numpy(), kept)
        assert (tris_out[b, len(kept):] == cap_e).all()
    # and the Pallas kernel in interpret mode on the rows read, one lane
    if B == 1:
        pal = jfk.fused_round(sup, alive, rm, read, bt=8, interpret=True) \
            if T % 8 == 0 else jfk.fused_round(
                sup, alive, rm, _pad_to(read[0], -(-T // 8) * 8, cap_e)[None],
                bt=8, interpret=True)
        for g, w in zip(got, pal):
            np.testing.assert_array_equal(g.numpy(), np.asarray(w))


def test_fused_round_live_rejects_aliased_buffers():
    sup = torch.zeros((1, 8), dtype=torch.int32)
    tris = torch.full((1, 4, 3), 8, dtype=torch.int32)
    n = torch.full((1,), 4, dtype=torch.int32)
    with pytest.raises(ValueError):
        tfk.fused_round_live(sup, sup, sup, tris, n, tris, n.clone())
    with pytest.raises(ValueError):
        tfk.fused_round_live(sup, sup, sup, tris, n, tris.clone(), n)
    with pytest.raises(ValueError):
        tfk.fused_round_live(sup, sup, sup, tris, n[:0], tris.clone(),
                             n.clone())
    with pytest.raises(TypeError):
        tfk.fused_round_live(sup, sup, sup, tris, n.long(), tris.clone(),
                             n.clone())


@pytest.mark.parametrize("cap_e,n_lanes", [(64, 3), (128, 2)])
def test_peel_classes_fused_live_rows_match_jax(cap_e, n_lanes):
    """The live-row loop on trimmed rows with per-lane counts (padding in
    the middle of lanes) against the JAX loop on the full padded rows."""
    sup, tris, alive = _batch(31 + cap_e, cap_e, n_lanes)
    B, T, _ = tris.shape
    holey = np.full((B, T + 8, 3), cap_e, np.int32)
    holey[:, :5] = tris[:, :5]
    holey[:, 9:T + 4] = tris[:, 5:]        # four padding rows at 5..8
    real = (holey < cap_e).all(axis=2)
    n_rows = np.where(real.any(1), real.shape[1] - np.argmax(real[:, ::-1],
                                                            axis=1), 0)
    pad_t = -(-holey.shape[1] // 8) * 8
    holey_p = np.full((B, pad_t, 3), cap_e, np.int32)
    holey_p[:, :holey.shape[1]] = holey
    phi_j, st_j = jops.peel_classes_fused(sup, holey_p, alive, bt=8,
                                          interpret=True)
    trimmed = _t(np.ascontiguousarray(holey[:, :max(int(n_rows.max()), 1)]))
    before = trimmed.clone()
    phi_t, st_t = tops.peel_classes_fused(
        _t(sup), trimmed, _t(alive), n_rows=_t(n_rows), cap_t=pad_t)
    np.testing.assert_array_equal(phi_t.numpy(), np.asarray(phi_j))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert torch.equal(trimmed, before)      # the caller's rows stay


@pytest.mark.parametrize("thresh", [1, 3])
def test_peel_threshold_fused_live_rows_match_jax(thresh):
    """Unpadded rows and edges (the candidate upload) against the JAX loop
    on pow4-padded ones; the caller's rows are left as they were."""
    rng = np.random.default_rng(41 + thresh)
    sup, alive, tris, m = _lane(rng, 20, 0.45, 128)
    removable = (rng.random(128) < 0.7).astype(np.int32)
    alive[rng.integers(0, m, 4)] = 0
    tris_p = _pad_to(tris, -(-len(tris) // 8) * 8 + 8, 128)
    want = jops.peel_threshold_fused(sup, tris_p, removable, thresh, alive,
                                     bt=8, interpret=True)
    rows = _t(tris)
    before = rows.clone()
    got = tops.peel_threshold_fused(_t(sup[:m]), rows, _t(removable[:m]),
                                    thresh, _t(alive[:m]))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want)[:m])
    assert torch.equal(rows, before)


def _counting_round(monkeypatch):
    """Replace the round binding with one that records each call's live
    row count and calls the real one."""
    calls = []
    real = tfk.fused_round_live

    def counted(sup, alive, rm, tris, n_rows, tris_out, n_rows_out):
        calls.append(int(n_rows.sum()))
        return real(sup, alive, rm, tris, n_rows, tris_out, n_rows_out)

    monkeypatch.setattr(tfk, "fused_round_live", counted)
    return calls


def test_peel_threshold_fused_launches_round_without_live_rows(monkeypatch):
    """A round that removes edges after the last triangle died still goes
    through the round binding (with zero live rows), as every removing
    round does."""
    calls = _counting_round(monkeypatch)
    got = tops.peel_threshold_fused(_t([0, 1, 1]), _t([[0, 1, 2]]),
                                    _t([1, 1, 1]), 0, _t([1, 1, 1]))
    assert got.tolist() == [0, 0, 0]
    assert calls == [1, 0]     # round 1 kills the triangle; round 2 has none


def test_peel_classes_fused_launches_every_removing_round(monkeypatch):
    """One round call for every round that removes an edge, including the
    round after the last triangle died: on a diamond (two triangles on
    edge 0), k = 3 removes the four outer edges, then edge 0 with no live
    row left.  phi and stats equal the JAX loop's."""
    calls = _counting_round(monkeypatch)
    sup = np.array([[2, 1, 1, 1, 1]], np.int32)
    alive = np.ones((1, 5), np.int32)
    tris = _pad_to(np.array([[0, 1, 2], [0, 3, 4]], np.int32), 8, 5)[None]
    phi_j, st_j = jops.peel_classes_fused(sup, tris, alive, bt=8,
                                          interpret=True)
    phi_t, st_t = tops.peel_classes_fused(_t(sup), _t(tris), _t(alive))
    np.testing.assert_array_equal(phi_t.numpy(), np.asarray(phi_j))
    np.testing.assert_array_equal(st_t.numpy(), np.asarray(st_j))
    assert phi_t.tolist() == [[3, 3, 3, 3, 3]]
    assert calls == [8, 0]     # every row of the buffer, then none
