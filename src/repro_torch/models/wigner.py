"""Wigner-D rotations of real spherical-harmonic coefficients (eSCN).

Twin of ``repro/models/wigner.py``. EquiformerV2's eSCN trick rotates
every edge's irrep features into an edge-aligned frame, where SO(3)
convolutions collapse to SO(2) per-m mixing. Per edge this needs the
block-diagonal matrix ``M(R)`` acting on real-SH coefficient vectors,
where ``R`` maps the edge direction onto ŷ:

    M(R) per degree l is defined by  sh_l(R·u) = M_l(R) · sh_l(u)  ∀u.

Z-rotations are analytic (cos/sin mixing of (m, −m) pairs); the only
numeric constant is ``C_l = M_l(B)`` for the axis swap B (ẑ → x̂), fit by
exact least squares on seeded random directions, which gives x-rotations
by conjugation, ``M(Rx(θ)) = C · M(Rz(θ)) · Cᵀ``, and the edge rotation

    D_edge = M(Rx(ψ)) · M(Rz(φ)),   R_edge · v = ŷ.

The NumPy half (:func:`sh_real`, :func:`axis_swap_matrix` and what they
call) is a copy of the original, seeds and fit included, so the constants
are the JAX package's to the last bit. :func:`rot_z_real` and
:func:`edge_rotation` run on torch tensors in float32 on the directions'
device; ``C_l`` becomes a tensor once per device.
"""

from __future__ import annotations

import math
from functools import lru_cache

import numpy as np
import torch

__all__ = ["sh_real", "sh_basis_size", "rot_z_real", "axis_swap_matrix", "edge_rotation"]


def sh_basis_size(l_max: int) -> int:
    return (l_max + 1) ** 2


# ---------------------------------------------------------------------------
# Real spherical harmonics (numpy, exact reference)
# ---------------------------------------------------------------------------

def _legendre_all(l_max: int, x: np.ndarray) -> np.ndarray:
    """Associated Legendre P_l^m(x) (with Condon–Shortley) for 0≤m≤l≤l_max."""
    n = x.shape[0]
    p = np.zeros((l_max + 1, l_max + 1, n))
    p[0, 0] = 1.0
    somx2 = np.sqrt(np.maximum(1.0 - x * x, 0.0))
    for m in range(1, l_max + 1):
        p[m, m] = -(2 * m - 1) * somx2 * p[m - 1, m - 1]
    for m in range(0, l_max):
        p[m + 1, m] = (2 * m + 1) * x * p[m, m]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            p[l, m] = ((2 * l - 1) * x * p[l - 1, m] - (l + m - 1) * p[l - 2, m]) / (l - m)
    return p


def sh_real(l_max: int, dirs: np.ndarray) -> np.ndarray:
    """Real orthonormal SH Y_{lm}(u) for unit vectors u: [N, (l_max+1)²].

    Basis order per l: m = −l..l; Y_{1,−1} ∝ y, Y_{1,0} ∝ z, Y_{1,1} ∝ x.
    """
    u = dirs / np.linalg.norm(dirs, axis=1, keepdims=True)
    x, y, z = u[:, 0], u[:, 1], u[:, 2]
    phi = np.arctan2(y, x)
    p = _legendre_all(l_max, z)
    out = np.zeros((u.shape[0], sh_basis_size(l_max)))
    off = 0
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            norm = math.sqrt(
                (2 * l + 1) / (4 * math.pi) * math.factorial(l - am) / math.factorial(l + am)
            )
            if m == 0:
                val = norm * p[l, 0]
            elif m > 0:
                val = math.sqrt(2) * norm * p[l, am] * np.cos(am * phi)
            else:
                val = math.sqrt(2) * norm * p[l, am] * np.sin(am * phi)
            out[:, off + m + l] = val
        off += 2 * l + 1
    return out


def _fit_block(l: int, rot: np.ndarray) -> np.ndarray:
    """M_l(R) via exact least squares: sh_l(R u) = M_l sh_l(u)."""
    rng = np.random.default_rng(1234 + l)
    u = rng.normal(size=(max(64, 8 * (2 * l + 1) ** 2), 3))
    u /= np.linalg.norm(u, axis=1, keepdims=True)
    lo = l * l
    hi = (l + 1) ** 2
    a = sh_real(l, u)[:, lo:hi]
    b = sh_real(l, u @ rot.T)[:, lo:hi]
    m, res, _, _ = np.linalg.lstsq(a, b, rcond=None)
    m = m.T
    err = np.abs(a @ m.T - b).max()
    assert err < 1e-8, f"Wigner fit failed for l={l}: {err}"
    return m


_B = np.array([[0.0, 0.0, 1.0], [0.0, 1.0, 0.0], [-1.0, 0.0, 0.0]])  # ẑ → x̂


@lru_cache(maxsize=16)
def axis_swap_matrix(l: int) -> np.ndarray:
    """C_l = M_l(B) with B·ẑ = x̂ (constant, orthogonal)."""
    return _fit_block(l, _B)


@lru_cache(maxsize=64)
def _axis_swap_tensor(l: int, device: torch.device) -> torch.Tensor:
    """``axis_swap_matrix(l)`` as a float32 tensor on ``device``, built once
    (callers must not write to it)."""
    return torch.as_tensor(axis_swap_matrix(l), dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Rotations (torch, float32)
# ---------------------------------------------------------------------------

def rot_z_real(l: int, theta: torch.Tensor) -> torch.Tensor:
    """M_l(Rz(θ)) analytic: acts on (m, −m) pairs. theta: [...] float32."""
    dim = 2 * l + 1
    theta = theta.to(torch.float32)
    out = torch.zeros(theta.shape + (dim, dim), dtype=torch.float32, device=theta.device)
    out[..., l, l] = 1.0
    for m in range(1, l + 1):
        c = torch.cos(m * theta)
        s = torch.sin(m * theta)
        # φ → φ + θ: cos(m(φ+θ)) = cos·cos − sin·sin ; sin(m(φ+θ)) = …
        out[..., l + m, l + m] = c
        out[..., l - m, l - m] = c
        out[..., l + m, l - m] = -s
        out[..., l - m, l + m] = s
    return out


def edge_rotation(l_max: int, directions: torch.Tensor) -> torch.Tensor:
    """Per-edge block-diagonal D with D·sh(v) = sh(ŷ): [E, dim, dim] float32.

    R = Rx(ψ)·Rz(φ): Rz(φ) brings v into the y–z plane (y ≥ 0), Rx(ψ)
    rotates it onto ŷ. M(Rx(ψ)) = C·M(Rz(ψ))·Cᵀ with the constant C. A
    zero direction (a self-loop, a padded edge) gives φ = ψ = 0, the
    identity rotation, as in the original.
    """
    e = directions.shape[0]
    dim = sh_basis_size(l_max)
    v = directions.to(torch.float32)
    r = torch.linalg.vector_norm(v, dim=-1, keepdim=True) + 1e-12
    u = v / r
    x, y, z = u[..., 0], u[..., 1], u[..., 2]
    # Rz(φ)·v zeroes the x-component and leaves y' = √(x²+y²) ≥ 0:
    phi = torch.atan2(x, y)
    y1 = torch.sin(phi) * x + torch.cos(phi) * y  # = sqrt(x²+y²) ≥ 0
    # Rx(ψ) maps (0, y1, z) → ŷ: ψ = atan2(-z, y1) with Rx as in _B-frame.
    psi = torch.atan2(-z, y1)

    out = torch.zeros((e, dim, dim), dtype=torch.float32, device=v.device)
    off = 0
    for l in range(l_max + 1):
        c = _axis_swap_tensor(l, v.device)
        nl = 2 * l + 1
        # C · Zb · Cᵀ · Za, left to right
        out[:, off:off + nl, off:off + nl] = (c @ rot_z_real(l, psi) @ c.T) @ rot_z_real(l, phi)
        off += nl
    return out
