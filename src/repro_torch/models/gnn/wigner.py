"""Real-spherical-harmonic rotation matrices (Wigner D in the real basis;
port of the JAX package's ``models/gnn/wigner.py``).

Ivanic & Ruedenberg recursion ("Rotation Matrices for Real Spherical
Harmonics", J. Phys. Chem. 1996, and the 1998 erratum): D^l is built from
D^{l-1} and the l = 1 block.  Each entry is the reference's sum of
products, in its order, in float32; the entries of a degree are computed
together on gathered operands (one tensor over a batch of rotations, one
per graph edge), where the reference loops over them.

Convention: the real harmonics of degree l are ordered m = -l..l; the l = 1
block is the 3x3 rotation conjugated by the (y, z, x) axis permutation.
``wigner_stack`` returns the block-diagonal (S, S) matrix for S = (l_max +
1)^2, the layout EquiformerV2's eSCN layer uses: features are rotated into
each edge's frame, mixed there by SO(2) convolutions and rotated back.
"""

from __future__ import annotations

import functools
import math

import numpy as np
import torch


def _delta(a, b):
    return 1.0 if a == b else 0.0


def _uvw(l: int, m: int, n: int):
    """Recursion coefficients u, v, w (Table 1 of Ivanic-Ruedenberg)."""
    am = abs(m)
    if abs(n) < l:
        d = (l + n) * (l - n)
    else:
        d = (2 * l) * (2 * l - 1)
    u = math.sqrt((l + m) * (l - m) / d)
    v = 0.5 * math.sqrt((1 + _delta(m, 0)) * (l + am - 1) * (l + am) / d) \
        * (1 - 2 * _delta(m, 0))
    w = -0.5 * math.sqrt((l - am - 1) * (l - am) / d) * (1 - _delta(m, 0))
    return u, v, w


_SH1 = [1, 2, 0]      # m = -1, 0, 1 -> y, z, x


def _rot_to_sh1(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotations -> l = 1 real-SH blocks (basis order y, z, x):
    D1[i, j] = R[axis(i), axis(j)]."""
    return R[..., _SH1, :][..., :, _SH1]


def _terms(l: int) -> list:
    """Degree l's recursion as five P terms an entry: for each entry (m,
    n), m-major, the coefficients (u, v, w), then each term's (i, a,
    weight): U's one, V's two and W's two (Table 2 of Ivanic-Ruedenberg).
    A term whose coefficient is 0 is still listed; it adds an exact 0."""
    rows = []
    for m in range(-l, l + 1):
        for n in range(-l, l + 1):
            u, v, w = _uvw(l, m, n)
            if m == 0:
                vt = ((1, 1, 1.0), (-1, -1, 1.0))
            elif m > 0:
                vt = ((1, m - 1, math.sqrt(1 + _delta(m, 1))),
                      (-1, -m + 1, -(1 - _delta(m, 1))))
            else:
                vt = ((1, m + 1, 1 - _delta(m, -1)),
                      (-1, -m - 1, math.sqrt(1 + _delta(m, -1))))
            wt = (((1, m + 1, 1.0), (-1, -m - 1, 1.0)) if m > 0 else
                  ((1, m - 1, 1.0), (-1, -m + 1, -1.0)))
            rows.append(((u, v, w), ((0, m, 1.0),) + vt + wt, n))
    return rows


def _p_cols(l: int, n: int):
    """The recursion's helper P_i(l; a, n) (Ivanic-Ruedenberg) for column
    n as two products r[i, j] * M^{l-1}[a, b]: (j, b, sign) each; a column
    inside the block has one (the second's sign 0)."""
    if n == -l:
        return (1, -l + 1, 1.0), (-1, l - 1, 1.0)
    if n == l:
        return (1, l - 1, 1.0), (-1, -l + 1, -1.0)
    return (0, n, 1.0), (0, n, 0.0)


@functools.lru_cache(maxsize=None)
def _gather_plan(l: int) -> tuple:
    """Degree l's gather indices and weights as numpy arrays: r's and the
    padded M^{l-1}'s flat indices (K, 5, 2), the second products' signs and
    the V / W weights (K, 5), the (u, v, w) coefficients (K, 3)."""
    pad = 2
    rows = _terms(l)
    ridx, midx, sgn, wts = [], [], [], []
    for _, terms, n in rows:
        (j1, b1, _), (j2, b2, s2) = _p_cols(l, n)
        for i, a, wt in terms:
            row = a + l - 1 + pad
            ridx += [(i + 1) * 3 + j1 + 1, (i + 1) * 3 + j2 + 1]
            midx += [row * (2 * l - 1) + b1 + l - 1,
                     row * (2 * l - 1) + b2 + l - 1]
            sgn.append(s2)
            wts.append(wt)
    K = len(rows)
    return (np.array(ridx, np.int64), np.array(midx, np.int64),
            np.array(sgn, np.float64).reshape(K, 5),
            np.array(wts, np.float64).reshape(K, 5),
            np.array([c for c, _, _ in rows], np.float64))


def _degree(r: torch.Tensor, Mprev: torch.Tensor, l: int) -> torch.Tensor:
    """D^l from D^{l-1} (``Mprev``, (..., 2l-1, 2l-1)) and the l = 1 block
    ``r``, every entry at once: the loop version's products and sums, in
    its order, on gathered operands (an absent term adds an exact zero)."""
    batch = tuple(r.shape[:-2])
    K, pad = (2 * l + 1) ** 2, 2
    wm = 2 * l - 1 + 2 * pad                 # Mprev rows padded by 2 a side
    Mp = torch.nn.functional.pad(Mprev, (0, 0, pad, pad)).reshape(
        batch + (wm * (2 * l - 1),))
    rf = r.reshape(batch + (9,))
    ridx, midx, sgn, wts, coef = _gather_plan(l)
    dev, dt = r.device, r.dtype
    ridx = torch.as_tensor(ridx, device=dev)
    midx = torch.as_tensor(midx, device=dev)
    sgn = torch.as_tensor(sgn, dtype=dt, device=dev)
    wts = torch.as_tensor(wts, dtype=dt, device=dev)
    coef = torch.as_tensor(coef, dtype=dt, device=dev)
    prod = (torch.index_select(rf, -1, ridx) * torch.index_select(
        Mp, -1, midx)).reshape(batch + (K, 5, 2))
    P = prod[..., 0] + sgn * prod[..., 1]                    # (..., K, 5)
    V = P[..., 1] * wts[:, 1] + P[..., 2] * wts[:, 2]
    W = P[..., 3] + wts[:, 4] * P[..., 4]
    val = coef[:, 0] * P[..., 0] + coef[:, 1] * V + coef[:, 2] * W
    return val.reshape(batch + (2 * l + 1, 2 * l + 1))


def wigner_blocks(R: torch.Tensor, l_max: int) -> list:
    """Per-degree rotation blocks ``[D^0, ..., D^{l_max}]`` of rotations R
    (..., 3, 3): a list of (..., 2l+1, 2l+1).  Each degree's entries are
    computed together (``_degree``): a few dozen ops a degree, where an op
    an entry would be thousands."""
    batch = tuple(R.shape[:-2])
    blocks = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return blocks
    r = _rot_to_sh1(R)
    blocks.append(r)
    for l in range(2, l_max + 1):
        blocks.append(_degree(r, blocks[-1], l))
    return blocks


def wigner_stack(R: torch.Tensor, l_max: int) -> torch.Tensor:
    """Block-diagonal (..., S, S) rotation over every degree, S = (l_max +
    1)^2."""
    blocks = wigner_blocks(R, l_max)
    S = (l_max + 1) ** 2
    out = R.new_zeros(tuple(R.shape[:-2]) + (S, S))
    off = 0
    for l, B in enumerate(blocks):
        w = 2 * l + 1
        out[..., off:off + w, off:off + w] = B
        off += w
    return out


def rotation_to_z(d: torch.Tensor, eps: float = 1e-9) -> torch.Tensor:
    """Rotations R with R @ d_hat = z_hat (rows: the new frame's axes)."""
    d = d / (torch.linalg.norm(d, dim=-1, keepdim=True) + eps)
    ref = torch.where(d[..., 2:3].abs() > 0.99,
                      d.new_tensor([1.0, 0.0, 0.0]),
                      d.new_tensor([0.0, 0.0, 1.0]))
    x = ref - d * (ref * d).sum(dim=-1, keepdim=True)
    x = x / (torch.linalg.norm(x, dim=-1, keepdim=True) + eps)
    y = torch.linalg.cross(d, x, dim=-1)
    return torch.stack([x, y, d], dim=-2)
