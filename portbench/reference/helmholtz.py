"""Plain NumPy reference of the 5-point PML Helmholtz discretization.

A frozen, independent copy of the reference solver's assembly (the report's
`code.py`, lines 11-115: the PML profiles, the complex stretchings, the
velocity fields c1 and c2, the source f1 and the 5-point coefficients), with
the velocity sampled at the stencil point itself ("corrected" fidelity).  It
takes only numbers from the harness: the grid size, the PML width and
constant, the frequency and the source positions.  It imports nothing of the
program and takes nothing the program built, so it can judge the program's
solutions: `true_residuals` re-derives A and f in complex128 and returns
||A u - f|| / ||f|| for each solution u.

Layout: a grid array is (n, n) with [row, col] = value at (x1 = (col+1) h,
x2 = (row+1) h), h = 1 / (n + 1); a solution is that grid flattened row by
row, as the program lays out its vectors.
"""
from __future__ import annotations

import math

import numpy as np


def sigma1(x, const, eta):
    """Two-sided quadratic damping profile (PML at x <= eta, x >= 1 - eta)."""
    amp = const / eta
    return np.where(x <= eta, amp * ((x - eta) / eta) ** 2,
                    np.where(x >= 1.0 - eta,
                             amp * ((x - 1.0 + eta) / eta) ** 2, 0.0))


def sigma2(x, const, eta):
    """One-sided damping profile (PML at x <= eta only; Dirichlet on top)."""
    amp = const / eta
    return np.where(x <= eta, amp * ((x - eta) / eta) ** 2, 0.0)


def stretch(sig, omega):
    return 1.0 / (1.0 + 1j * sig / omega)


def velocity(medium: str, x, y):
    """c1: the converging lens; c2: the wave-guiding channel; both centred
    on the domain's middle, 0.5."""
    if medium == "c1":
        r2 = (x - 0.5) ** 2 + (y - 0.5) ** 2
        return 4.0 / 3.0 * (1.0 - 0.5 * np.exp(-32.0 * r2))
    if medium == "c2":
        return 4.0 / 3.0 * (1.0 - 0.5 * np.exp(-32.0 * (x - 0.5) ** 2))
    raise ValueError(f"unknown medium {medium!r}")


def omega_of(wave_num: float, alpha: float) -> complex:
    return complex(2.0 * math.pi * wave_num, alpha)


def coefficients(n, b, const, omega, medium):
    """The five coefficient grids (cc, cw, ce, cs, cn), complex128, of the
    operator at complex frequency `omega`; a coupling that leaves the grid
    is zero (Dirichlet)."""
    h = 1.0 / (n + 1)
    eta = b * h
    k = np.arange(1, n + 1, dtype=np.float64)
    x1 = k[None, :] * h                      # along a row
    x2 = k[:, None] * h                      # down the rows
    s1_c = stretch(sigma1(x1, const, eta), omega)
    s1_m = stretch(sigma1(x1 - 0.5 * h, const, eta), omega)
    s1_p = stretch(sigma1(x1 + 0.5 * h, const, eta), omega)
    s2_c = stretch(sigma2(x2, const, eta), omega)
    s2_m = stretch(sigma2(x2 - 0.5 * h, const, eta), omega)
    s2_p = stretch(sigma2(x2 + 0.5 * h, const, eta), omega)
    inv_h2 = 1.0 / (h * h)
    shape = (n, n)
    cw = np.broadcast_to(inv_h2 * s1_m / s2_c, shape).copy()
    ce = np.broadcast_to(inv_h2 * s1_p / s2_c, shape).copy()
    cs = np.broadcast_to(inv_h2 * s2_m / s1_c, shape).copy()
    cn = np.broadcast_to(inv_h2 * s2_p / s1_c, shape).copy()
    c = velocity(medium, x1, x2)
    cc = omega ** 2 / (s1_c * s2_c * c ** 2) - (cw + ce + cs + cn)
    cw[:, 0] = 0
    ce[:, -1] = 0
    cs[0, :] = 0
    cn[-1, :] = 0
    return cc, cw, ce, cs, cn


def source_f1(n, omega, x, y):
    """Gaussian point source exp(-(4 omega / pi)^2 r^2) at (x, y)."""
    h = 1.0 / (n + 1)
    k = np.arange(1, n + 1, dtype=np.float64) * h
    r2 = (k[None, :] - x) ** 2 + (k[:, None] - y) ** 2
    return np.exp(-((4.0 * omega / math.pi) ** 2) * r2)


def apply(coef, u):
    """A u for one (n, n) grid."""
    cc, cw, ce, cs, cn = coef
    y = cc * u
    y[:, 1:] += cw[:, 1:] * u[:, :-1]
    y[:, :-1] += ce[:, :-1] * u[:, 1:]
    y[1:, :] += cs[1:, :] * u[:-1, :]
    y[:-1, :] += cn[:-1, :] * u[1:, :]
    return y


def true_residuals(solutions, *, n, b, const, alpha, wave_num, medium,
                   xs, ys, source="f1"):
    """||A u_k - f_k|| / ||f_k|| for each solution u_k (rows of a (K, n*n)
    array of any complex type), with A and f_k re-derived here in
    complex128 for the source at (xs[k], ys[k])."""
    if source != "f1":
        raise ValueError(f"unknown source {source!r}")
    omega = omega_of(wave_num, alpha)
    coef = coefficients(n, b, const, omega, medium)
    out = []
    for u, x, y in zip(solutions, xs, ys):
        f = source_f1(n, omega, float(x), float(y))
        r = apply(coef, np.asarray(u, np.complex128).reshape(n, n)) - f
        out.append(float(np.linalg.norm(r) / np.linalg.norm(f)))
    return out
