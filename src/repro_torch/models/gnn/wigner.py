"""Real Wigner-D rotations + real spherical harmonics for eSCN/EquiformerV2.

Port of ``repro/models/gnn/wigner.py``.  The eSCN trick (arXiv:2302.03655,
used by EquiformerV2 arXiv:2306.12059): rotate each edge's source irreps
into a frame where the edge direction is the z-axis; there the SO(3)
tensor-product convolution reduces to per-|m| SO(2) linear maps (O(L^3)
instead of O(L^6)); rotate back after mixing.

The rotation D_real^l(R) for R = Rz(phi) @ Ry(theta) (which maps z-hat onto
the edge direction r-hat) is built from static coefficient tensors, so the
per-edge evaluation is a handful of einsums over data-dependent angles:

  * small-d:  d^l(beta) = sum_p  A_l[..., p] * cos(beta/2)^(2l-p) sin(beta/2)^p
  * z-rot:    Dz^l(alpha) = sum_m cos(m alpha) Zc_l[m] + sin(m alpha) Zs_l[m]
  * D_real^l = Dz^l(phi) @ Dy^l(theta),   block-diagonal over l.

The coefficient builders are the JAX package's NumPy code (complex Wigner
formula + complex->real basis change U), carried over verbatim; their f32
tensors are cached per device.  They satisfy the defining property
  sh_real(R v) = D_real(R) @ sh_real(v)
(tests/test_torch_gnn_symmetry.py).  Real SH here use the same U convention.
"""
from __future__ import annotations

import functools
import math
from typing import List, Tuple

import numpy as np
import torch

__all__ = [
    "real_wigner_coeffs",
    "wigner_d_blocks",
    "rotate_irreps",
    "sh_real",
    "dir_to_angles",
    "irreps_dim",
]


def irreps_dim(l_max: int) -> int:
    return (l_max + 1) ** 2


@functools.lru_cache(maxsize=None)
def _u_matrix(l: int) -> np.ndarray:
    """Complex->real change of basis: sh_real = U @ sh_complex.

    Index order m = -l..l.  Convention: Y^r_{l,m>0} = sqrt2*(-1)^m Re Y_l^m,
    Y^r_{l,-m} = sqrt2*(-1)^m Im Y_l^m, Y^r_{l,0} = Y_l^0."""
    n = 2 * l + 1
    u = np.zeros((n, n), dtype=np.complex128)
    u[l, l] = 1.0
    for m in range(1, l + 1):
        cs = (-1.0) ** m
        u[l + m, l + m] = cs / math.sqrt(2)  # coeff of Y_l^{+m}
        u[l + m, l - m] = 1.0 / math.sqrt(2)  # coeff of Y_l^{-m}
        u[l - m, l + m] = cs / (1j * math.sqrt(2))
        u[l - m, l - m] = -1.0 / (1j * math.sqrt(2))
    return u


@functools.lru_cache(maxsize=None)
def _small_d_monomials(l: int) -> np.ndarray:
    """Complex small-d coefficients: d^l_{m'm}(b) = sum_p C[m'+l, m+l, p]
    cos(b/2)^(2l-p) sin(b/2)^p  (Wigner's formula)."""
    n = 2 * l + 1
    c = np.zeros((n, n, 2 * l + 1), dtype=np.float64)
    f = [math.factorial(i) for i in range(2 * l + 1)]
    for mp in range(-l, l + 1):
        for m in range(-l, l + 1):
            pref = math.sqrt(
                f[l + m] * f[l - m] * f[l + mp] * f[l - mp]
            )
            for k in range(0, 2 * l + 1):
                a1 = l + m - k
                a2 = k
                a3 = l - k - mp
                a4 = k - m + mp
                if min(a1, a2, a3, a4) < 0:
                    continue
                p = 2 * k - m + mp  # sin exponent
                coeff = (-1.0) ** k * pref / (f[a1] * f[a2] * f[a3] * f[a4])
                c[mp + l, m + l, p] += coeff
    return c


@functools.lru_cache(maxsize=None)
def real_wigner_coeffs(l: int) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(A, Zc, Zs) static tensors for degree l:

    A  [2l+1, 2l+1, 2l+1] — real small-d monomial coefficients
    Zc [l+1, 2l+1, 2l+1]  — cos(m*alpha) terms of the real z-rotation
    Zs [l+1, 2l+1, 2l+1]  — sin(m*alpha) terms
    """
    u = _u_matrix(l)
    uh = u.conj().T
    cmono = _small_d_monomials(l)
    n = 2 * l + 1
    a = np.zeros_like(cmono)
    for p in range(2 * l + 1):
        m = u @ cmono[:, :, p] @ uh
        assert np.abs(m.imag).max() < 1e-10
        a[:, :, p] = m.real
    zc = np.zeros((l + 1, n, n))
    zs = np.zeros((l + 1, n, n))
    ms = np.arange(-l, l + 1)
    for m0 in range(l + 1):
        cdiag = np.diag((np.abs(ms) == m0).astype(np.complex128))
        sdiag = np.diag(np.where(np.abs(ms) == m0, np.sign(ms), 0).astype(np.complex128))
        zc_m = u @ cdiag @ uh
        zs_m = -1j * (u @ sdiag @ uh)
        assert np.abs(zc_m.imag).max() < 1e-10
        assert np.abs(zs_m.imag).max() < 1e-10
        zc[m0] = zc_m.real
        zs[m0] = zs_m.real
    return a, zc, zs


@functools.lru_cache(maxsize=None)
def _coeff_tensors(l: int, device: torch.device) -> Tuple[torch.Tensor, ...]:
    """Degree ``l``'s (A, Zc, Zs) as f32 tensors on ``device``, with the
    monomial exponents (2l - p, p) and the orders m = 0..l."""
    a, zc, zs = (torch.as_tensor(x, dtype=torch.float32, device=device)
                 for x in real_wigner_coeffs(l))
    p = torch.arange(2 * l + 1, dtype=torch.float32, device=device)
    m0 = torch.arange(l + 1, dtype=torch.float32, device=device)
    return a, zc, zs, 2 * l - p, p, m0


def dir_to_angles(vec: torch.Tensor, eps: float = 1e-9) -> Tuple[torch.Tensor, torch.Tensor]:
    """Unit-ish vectors [..., 3] -> (theta polar-from-z, phi azimuth)."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + eps)
    theta = torch.arccos(torch.clamp(z / r, -1.0 + 1e-7, 1.0 - 1e-7))
    phi = torch.atan2(y, x)
    return theta, phi


def wigner_d_blocks(
    l_max: int, theta: torch.Tensor, phi: torch.Tensor
) -> List[torch.Tensor]:
    """Per-l real rotation matrices D_real^l(Rz(phi) Ry(theta)), each
    [..., 2l+1, 2l+1].  The rotation maps z-hat to the (theta, phi) direction;
    apply the transpose to bring features *into* the edge frame."""
    c = torch.cos(theta / 2.0)
    s = torch.sin(theta / 2.0)
    blocks = []
    for l in range(l_max + 1):
        a, zc, zs, cos_pow, sin_pow, m0 = _coeff_tensors(l, theta.device)
        mono = c[..., None] ** cos_pow * s[..., None] ** sin_pow  # [..., 2l+1]
        # the raw U-conjugated factors come out as D(R^-1) = D(R)^T in this
        # convention (verified against l=1 3x3 rotations) -> transpose each.
        dy = torch.einsum("...p,nmp->...mn", mono, a)
        cosm = torch.cos(m0 * phi[..., None])  # [..., l+1]
        sinm = torch.sin(m0 * phi[..., None])
        dz = torch.einsum("...m,mji->...ij", cosm, zc) + torch.einsum(
            "...m,mji->...ij", sinm, zs
        )
        blocks.append(torch.einsum("...ij,...jk->...ik", dz, dy))
    return blocks


def rotate_irreps(
    feats: torch.Tensor,  # [..., (l_max+1)^2, C]
    blocks: List[torch.Tensor],  # per-l [..., 2l+1, 2l+1]
    transpose: bool = False,
) -> torch.Tensor:
    """Apply the block-diagonal rotation to irreps features."""
    out = []
    off = 0
    for l, d in enumerate(blocks):
        n = 2 * l + 1
        seg = feats[..., off : off + n, :]
        eq = "...ji,...jc->...ic" if transpose else "...ij,...jc->...ic"
        out.append(torch.einsum(eq, d, seg))
        off += n
    return torch.cat(out, dim=-2)


# ----------------------------------------------------- real SH (same basis)
def sh_real(l_max: int, vec: torch.Tensor) -> torch.Tensor:
    """Real spherical harmonics [..., (l_max+1)^2] in the U-matrix basis
    (m = -l..l per l), evaluated via associated-Legendre recursion."""
    x, y, z = vec[..., 0], vec[..., 1], vec[..., 2]
    r = torch.sqrt(x * x + y * y + z * z + 1e-12)
    ct = z / r
    st = torch.sqrt(torch.clamp(1.0 - ct * ct, 0.0, 1.0))
    phi = torch.atan2(y, x)
    # P_l^m with Condon-Shortley, m >= 0
    plm = {}
    plm[(0, 0)] = torch.ones_like(ct)
    for m in range(1, l_max + 1):
        plm[(m, m)] = (
            (-1.0) ** m
            * float(np.prod(np.arange(1, 2 * m, 2)))
            * st ** m
        )
    for m in range(0, l_max):
        plm[(m + 1, m)] = (2 * m + 1) * ct * plm[(m, m)]
    for m in range(0, l_max + 1):
        for l in range(m + 2, l_max + 1):
            plm[(l, m)] = (
                (2 * l - 1) * ct * plm[(l - 1, m)] - (l + m - 1) * plm[(l - 2, m)]
            ) / (l - m)
    comps = []
    for l in range(l_max + 1):
        for m in range(-l, l + 1):
            am = abs(m)
            nlm = math.sqrt(
                (2 * l + 1)
                / (4 * math.pi)
                * math.factorial(l - am)
                / math.factorial(l + am)
            )
            # complex Y_l^m = N P_l^m e^{imphi}; real basis via U:
            # m>0: sqrt2*(-1)^m Re Y = sqrt2*(-1)^m N P cos(m phi)
            # m<0: sqrt2*(-1)^m Im Y_l^{|m|} = sqrt2*(-1)^m N P sin(|m| phi)
            if m == 0:
                comps.append(nlm * plm[(l, 0)])
            elif m > 0:
                comps.append(
                    math.sqrt(2) * (-1.0) ** m * nlm * plm[(l, m)] * torch.cos(m * phi)
                )
            else:
                comps.append(
                    math.sqrt(2) * (-1.0) ** am * nlm * plm[(l, am)] * torch.sin(am * phi)
                )
    return torch.stack(comps, dim=-1)
