"""PML damping profiles and complex coordinate-stretching functions, as
element-wise tensor functions over whole coordinate grids.

Conventions:
  * sigma1 is two-sided (PML at x<=eta and x>=1-eta): the x1 direction.
  * sigma2 is one-sided (PML at x<=eta only): the x2 direction; the top
    boundary (x2=1) is plain Dirichlet, no PML.
  * s(x) = 1 / (1 + i*sigma(x)/omega), the complex stretching factor.
  * s2m is sigma2 translated by (m-b)*h: the "moving PML" of Engquist-Ying
    Algorithm 2.3, the absorbing layer slid up to sit just below layer m.
"""
from __future__ import annotations

import torch


def sigma1(x: torch.Tensor, const, eta) -> torch.Tensor:
    """Two-sided quadratic damping profile."""
    amp = const / eta
    lo = amp * ((x - eta) / eta) ** 2
    hi = amp * ((x - 1.0 + eta) / eta) ** 2
    zero = torch.zeros_like(lo)
    return torch.where(x <= eta, lo, torch.where(x >= 1.0 - eta, hi, zero))


def sigma2(x: torch.Tensor, const, eta) -> torch.Tensor:
    """One-sided (bottom-only) quadratic damping profile."""
    amp = const / eta
    lo = amp * ((x - eta) / eta) ** 2
    return torch.where(x <= eta, lo, torch.zeros_like(lo))


def _stretch(sig: torch.Tensor, omega, complex_dtype) -> torch.Tensor:
    sig = sig.to(complex_dtype)
    return 1.0 / (1.0 + 1j * sig / complex(omega))


def s1(x, const, eta, omega, complex_dtype=torch.complex128):
    """Complex stretching for the x1 direction."""
    return _stretch(sigma1(x, const, eta), omega, complex_dtype)


def s2(x, const, eta, omega, complex_dtype=torch.complex128):
    """Complex stretching for the x2 direction."""
    return _stretch(sigma2(x, const, eta), omega, complex_dtype)


def s2m(x, m, b, const, eta, omega, h, complex_dtype=torch.complex128):
    """Moved-PML stretching: s2 evaluated at x - (m-b)*h.

    For subgrid layer coordinates x = j*h with j in m-b+1..m this equals
    s2(l*h) with l = j-(m-b) in 1..b: the moved PML profile depends only on
    the *local* layer index, which the batched subgrid assembly exploits.
    """
    return _stretch(sigma2(x - (m - b) * h, const, eta), omega, complex_dtype)
