"""SO(3) machinery for the eSCN / EquiformerV2 family.

The official eSCN/EquiformerV2 repos precompute one Wigner-D matrix per
edge and gather them.  The formulation here, the reference's, avoids
per-edge matrices entirely via the classic Z-Y-Z factorization in the
*real* spherical-harmonic basis:

    D(alpha, beta, 0) = Zr(alpha) · J · Zr(beta) · J

where ``J = d(pi/2)`` is a CONSTANT block-diagonal matrix (computed once
on the host from the complex Wigner small-d + the complex->real unitary)
and ``Zr(theta)`` is a per-edge *diagonal/2x2-block* phase — O((2l+1))
elementwise work.  Rotating features therefore costs two products with a
constant matrix plus two cheap phase multiplies, with zero per-edge
matrix storage.

Feature layout: x[(l,m)] flattened to a single axis of size (l_max+1)^2 in
the order (l=0,m=0), (l=1,m=-1..1), ... — matching e3nn conventions.

``Jb @ x`` with x (E, n, C) is one batched GEMM whose J operand is
broadcast over the edges (no copy).  The host-side tables (``J_matrix``,
``J_block``, ``m_indices``) are copies of the reference's numpy code.
"""
from __future__ import annotations

from functools import lru_cache
from math import factorial, sqrt

import numpy as np
import torch


def _small_d_entry(l: int, mp: int, m: int, beta: float) -> float:
    """Complex-basis Wigner small-d d^l_{mp,m}(beta) (Wikipedia convention)."""
    pref = sqrt(
        factorial(l + mp) * factorial(l - mp) * factorial(l + m) * factorial(l - m)
    )
    smin = max(0, m - mp)
    smax = min(l + m, l - mp)
    tot = 0.0
    for s in range(smin, smax + 1):
        num = (-1.0) ** (mp - m + s)
        den = (
            factorial(l + m - s) * factorial(s)
            * factorial(mp - m + s) * factorial(l - mp - s)
        )
        c = np.cos(beta / 2.0) ** (2 * l + m - mp - 2 * s)
        sn = np.sin(beta / 2.0) ** (mp - m + 2 * s)
        tot += num / den * c * sn
    return pref * tot


def _complex_to_real_U(l: int) -> np.ndarray:
    """U s.t. Y_real = U @ Y_complex, rows ordered m = -l..l (Condon-Shortley)."""
    n = 2 * l + 1
    U = np.zeros((n, n), dtype=np.complex128)
    for m in range(-l, l + 1):
        i = m + l
        if m < 0:
            U[i, m + l] = 1j / sqrt(2)
            U[i, -m + l] = -1j * (-1) ** m / sqrt(2)
        elif m == 0:
            U[i, l] = 1.0
        else:
            U[i, -m + l] = 1 / sqrt(2)
            U[i, m + l] = (-1) ** m / sqrt(2)
    return U


@lru_cache(maxsize=None)
def J_matrix(l: int) -> np.ndarray:
    """Real-basis J_l = D^l(g), g = rotation by pi about (y+z)/sqrt(2).

    g is an involution that conjugates Rz into Ry, so
    ``J Zr(beta) J = Ry(beta)`` and the ZYZ factorization
    ``D = Zr(alpha) J Zr(beta) J Zr(gamma)`` holds with a CONSTANT J.
    In ZYZ Euler form g = Rz(pi/2) Ry(pi/2) Rz(pi/2); we build its complex
    Wigner-D (z-phases e^{+i m theta} — the convention validated against the
    l=1 target) and conjugate into the real SH basis.
    """
    ms = np.arange(-l, l + 1)
    d = np.array(
        [[_small_d_entry(l, mp, m, np.pi / 2) for m in range(-l, l + 1)]
         for mp in range(-l, l + 1)]
    )
    Zc = np.diag(np.exp(1j * ms * (np.pi / 2)))
    Dg = Zc @ d.astype(np.complex128) @ Zc
    U = _complex_to_real_U(l)
    J = U @ Dg @ U.conj().T
    assert np.abs(J.imag).max() < 1e-9, "J must be real in the real SH basis"
    return J.real


@lru_cache(maxsize=None)
def J_block(l_max: int) -> np.ndarray:
    """Block-diagonal J over all l <= l_max: ((l_max+1)^2, (l_max+1)^2)."""
    n = (l_max + 1) ** 2
    out = np.zeros((n, n))
    off = 0
    for l in range(l_max + 1):
        k = 2 * l + 1
        out[off:off + k, off:off + k] = J_matrix(l)
        off += k
    return out


@lru_cache(maxsize=None)
def m_indices(l_max: int):
    """Per-coefficient (l, m) and the index of the (l, -m) partner."""
    ls, ms, partner = [], [], []
    off = 0
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            ls.append(l)
            ms.append(m)
            partner.append(off + (-m + l))
        off += 2 * l + 1
    return np.array(ls), np.array(ms), np.array(partner)


@lru_cache(maxsize=None)
def _m_tables(l_max: int, device: torch.device):
    """``m`` per coefficient (float32) and the (l, -m) partner (int64) on
    ``device``: constants, made once per device."""
    _, ms, partner = m_indices(l_max)
    return (torch.as_tensor(ms, dtype=torch.float32, device=device),
            torch.as_tensor(partner, dtype=torch.int64, device=device))


def J_tensor(l_max: int, dtype, device) -> torch.Tensor:
    """``J_block(l_max)`` (float64) cast straight to ``dtype`` on
    ``device``, as the reference's ``jnp.asarray(J_block(L), dtype)``:
    made once per forward, not per edge."""
    return torch.as_tensor(J_block(l_max), device=device).to(dtype)


def z_rotate(x, theta, l_max: int):
    """Real-basis rotation about z by per-edge angle theta.

    x: (E, (l_max+1)^2, C); theta: (E,).  Real-basis z-rotation mixes the
    (l, m) and (l, -m) pair:  y_m = cos(m t) x_m - sin(m t) x_{-m}.
    """
    m, part = _m_tables(l_max, x.device)
    ang = theta[:, None] * m[None, :]
    c = torch.cos(ang)[..., None].to(x.dtype)
    s = torch.sin(ang)[..., None].to(x.dtype)
    return c * x - s * x.index_select(1, part)


def euler_from_edges(edge_vec):
    """(alpha, beta) s.t. Rz(-alpha) then Ry(-beta) maps the edge onto +z.

    Returns per-edge angles; degenerate (zero-length) edges get zeros.
    """
    n = edge_vec / torch.clamp(
        torch.linalg.vector_norm(edge_vec, dim=-1, keepdim=True), min=1e-9)
    beta = torch.arccos(torch.clamp(n[:, 2], -1.0, 1.0))
    alpha = torch.atan2(n[:, 1], n[:, 0])
    return alpha, beta


def rotate_to_frame(x, alpha, beta, l_max: int, Jb):
    """Apply D(0, -beta, -alpha): world frame -> edge-aligned frame.
    ``Jb @ x`` is the reference's ``einsum("ij,ejc->eic", Jb, x)``."""
    x = z_rotate(x, -alpha, l_max)
    x = Jb @ x
    x = z_rotate(x, -beta, l_max)
    return Jb @ x


def rotate_from_frame(x, alpha, beta, l_max: int, Jb):
    """Inverse of rotate_to_frame (J is symmetric-orthogonal: J^{-1}=J^T)."""
    x = Jb.T @ x
    x = z_rotate(x, beta, l_max)
    x = Jb.T @ x
    return z_rotate(x, alpha, l_max)


def rotation_matrix_l1(alpha, beta):
    """The l=1 real-SH-basis (y,z,x) rotation D(0,-beta,-alpha) as (E,3,3)
    matrices — used by equivariance tests to compare against plain 3D
    rotation of vectors."""
    E = alpha.shape[0]
    Jb = J_tensor(1, torch.float32, alpha.device)
    cols = []
    for i in range(3):
        basis = torch.zeros((E, 4, 1), dtype=torch.float32,
                            device=alpha.device)
        basis[:, i + 1, 0] = 1.0
        cols.append(rotate_to_frame(basis, alpha, beta, 1, Jb)[:, 1:, 0])
    return torch.stack(cols, dim=-1)  # (E, 3, 3) columns = images of y,z,x
