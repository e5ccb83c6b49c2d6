"""Real-spherical-harmonic rotation matrices (Wigner D in the real basis;
port of the JAX package's ``models/gnn/wigner.py``).

Ivanic & Ruedenberg recursion ("Rotation Matrices for Real Spherical
Harmonics", J. Phys. Chem. 1996, and the 1998 erratum): D^l is built from
D^{l-1} and the l = 1 block, entry by entry, with static Python loops over
(l, m, n), each entry a tensor over a batch of rotations (one per graph
edge).  The same recursion, in the same order, in float32.

Convention: the real harmonics of degree l are ordered m = -l..l; the l = 1
block is the 3x3 rotation conjugated by the (y, z, x) axis permutation.
``wigner_stack`` returns the block-diagonal (S, S) matrix for S = (l_max +
1)^2, the layout EquiformerV2's eSCN layer uses: features are rotated into
each edge's frame, mixed there by SO(2) convolutions and rotated back.
"""

from __future__ import annotations

import math

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


def _get(M, l, a, b):
    """Entry M^l_{a,b} of a batched (..., 2l+1, 2l+1) block; 0 out of
    range."""
    if abs(a) > l or abs(b) > l:
        return 0.0
    return M[..., a + l, b + l]


def _P(i, l, a, b, r, Mprev):
    """Helper P_i(l; a, b) of the recursion; r is the l = 1 block."""
    if b == -l:
        return (_get(r, 1, i, 1) * _get(Mprev, l - 1, a, -l + 1)
                + _get(r, 1, i, -1) * _get(Mprev, l - 1, a, l - 1))
    if b == l:
        return (_get(r, 1, i, 1) * _get(Mprev, l - 1, a, l - 1)
                - _get(r, 1, i, -1) * _get(Mprev, l - 1, a, -l + 1))
    return _get(r, 1, i, 0) * _get(Mprev, l - 1, a, b)


_SH1 = [1, 2, 0]      # m = -1, 0, 1 -> y, z, x


def _rot_to_sh1(R: torch.Tensor) -> torch.Tensor:
    """3x3 rotations -> l = 1 real-SH blocks (basis order y, z, x):
    D1[i, j] = R[axis(i), axis(j)]."""
    return R[..., _SH1, :][..., :, _SH1]


def wigner_blocks(R: torch.Tensor, l_max: int) -> list:
    """Per-degree rotation blocks ``[D^0, ..., D^{l_max}]`` of rotations R
    (..., 3, 3): a list of (..., 2l+1, 2l+1)."""
    batch = tuple(R.shape[:-2])
    blocks = [torch.ones(batch + (1, 1), dtype=R.dtype, device=R.device)]
    if l_max == 0:
        return blocks
    r = _rot_to_sh1(R)
    blocks.append(r)
    Mprev = r
    for l in range(2, l_max + 1):
        rows = []
        for m in range(-l, l + 1):
            cols = []
            for n in range(-l, l + 1):
                u, v, w = _uvw(l, m, n)
                val = 0.0
                if u != 0.0:
                    val = val + u * _P(0, l, m, n, r, Mprev)
                if v != 0.0:
                    if m == 0:
                        Vmn = (_P(1, l, 1, n, r, Mprev)
                               + _P(-1, l, -1, n, r, Mprev))
                    elif m > 0:
                        Vmn = (_P(1, l, m - 1, n, r, Mprev)
                               * math.sqrt(1 + _delta(m, 1))
                               - _P(-1, l, -m + 1, n, r, Mprev)
                               * (1 - _delta(m, 1)))
                    else:
                        Vmn = (_P(1, l, m + 1, n, r, Mprev)
                               * (1 - _delta(m, -1))
                               + _P(-1, l, -m - 1, n, r, Mprev)
                               * math.sqrt(1 + _delta(m, -1)))
                    val = val + v * Vmn
                if w != 0.0:
                    if m > 0:
                        Wmn = (_P(1, l, m + 1, n, r, Mprev)
                               + _P(-1, l, -m - 1, n, r, Mprev))
                    else:
                        Wmn = (_P(1, l, m - 1, n, r, Mprev)
                               - _P(-1, l, -m + 1, n, r, Mprev))
                    val = val + w * Wmn
                if not isinstance(val, torch.Tensor):
                    val = R.new_full(batch, val)
                cols.append(val)
            rows.append(torch.stack(cols, dim=-1))
        M = torch.stack(rows, dim=-2)
        blocks.append(M)
        Mprev = M
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
