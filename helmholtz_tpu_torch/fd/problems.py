"""Canonical velocity fields and forcings of the reference experiments.

Velocity fields c1 (converging lens) and c2 (wave-guiding channel), forcings f1
(Gaussian point source) and f2 (directed Gaussian wave packet):

  * velocity fields live on the full (n+2, n+2) grid including boundary,
    [row, col] = value at (x = col*h, y = row*h);
  * forcings live on the (n, n) interior grid, same orientation;
  * f1/f2 use the *complex* omega = 2*pi*wave_num + i*alpha in their
    Gaussians, so f is complex-valued.
"""
from __future__ import annotations

import math

import torch

from .._device import real_dtype_of


def _grids(n, interior, rdtype, device):
    x = torch.linspace(0.0, 1.0, n + 2, dtype=rdtype, device=device)
    if interior:
        x = x[1:-1]
    # xx varies along columns, yy along rows
    return torch.meshgrid(x, x, indexing="xy")


def init_c1_mat(r1, r2, n, rdtype=torch.float64, device="cpu"):
    """Converging lens: 4/3 * (1 - .5*exp(-32*((x-r1)^2 + (y-r2)^2))) on the
    full grid."""
    xx, yy = _grids(n, False, rdtype, device)
    return 4.0 / 3.0 * (1.0 - 0.5 * torch.exp(
        -32.0 * ((xx - r1) ** 2 + (yy - r2) ** 2)))


def init_c2_mat(n, rdtype=torch.float64, device="cpu"):
    """Wave-guiding channel: 4/3 * (1 - .5*exp(-32*(x-.5)^2))."""
    xx, _ = _grids(n, False, rdtype, device)
    return 4.0 / 3.0 * (1.0 - 0.5 * torch.exp(-32.0 * (xx - 0.5) ** 2))


def init_f1_mat(r1, r2, omega, n, complex_dtype=torch.complex128,
                device="cpu"):
    """Gaussian point source exp(-(4w/pi)^2 * r^2), interior grid.  Complex
    because omega is complex."""
    xx, yy = _grids(n, True, real_dtype_of(complex_dtype), device)
    omega = complex(omega)
    r2_ = ((xx - r1) ** 2 + (yy - r2) ** 2).to(complex_dtype)
    return torch.exp(-((4.0 * omega / math.pi) ** 2) * r2_)


def init_f2_mat(r1, r2, d1, d2, omega, n, complex_dtype=torch.complex128,
                device="cpu"):
    """Directed Gaussian wave packet aimed along (d1, d2)."""
    xx, yy = _grids(n, True, real_dtype_of(complex_dtype), device)
    omega = complex(omega)
    r2_ = ((xx - r1) ** 2 + (yy - r2) ** 2).to(complex_dtype)
    phase = (xx * d1 + yy * d2).to(complex_dtype)
    return torch.exp(-4.0 * omega * r2_) * torch.exp(1j * omega * phase)


# -- named problem instances with the paper's default positions --------------

def init_c1_f1(omega, n, cr1=0.5, cr2=0.5, fr1=0.5, fr2=0.125,
               complex_dtype=torch.complex128, device="cpu"):
    return (init_c1_mat(cr1, cr2, n, real_dtype_of(complex_dtype), device),
            init_f1_mat(fr1, fr2, omega, n, complex_dtype, device))


def init_c1_f2(omega, n, cr1=0.5, cr2=0.5, fr1=0.125, fr2=0.125,
               d1=2.0 ** -0.5, d2=2.0 ** -0.5,
               complex_dtype=torch.complex128, device="cpu"):
    return (init_c1_mat(cr1, cr2, n, real_dtype_of(complex_dtype), device),
            init_f2_mat(fr1, fr2, d1, d2, omega, n, complex_dtype, device))


def init_c2_f1(omega, n, r1=0.5, r2=0.5, complex_dtype=torch.complex128,
               device="cpu"):
    return (init_c2_mat(n, real_dtype_of(complex_dtype), device),
            init_f1_mat(r1, r2, omega, n, complex_dtype, device))


def init_c2_f2(omega, n, r1=0.5, r2=0.5, d1=2.0 ** -0.5, d2=2.0 ** -0.5,
               complex_dtype=torch.complex128, device="cpu"):
    return (init_c2_mat(n, real_dtype_of(complex_dtype), device),
            init_f2_mat(r1, r2, d1, d2, omega, n, complex_dtype, device))


PROBLEMS = {
    "c1_f1": init_c1_f1,
    "c1_f2": init_c1_f2,
    "c2_f1": init_c2_f1,
    "c2_f2": init_c2_f2,
}

# Velocity fields with no x2 (layer) dependence under CORRECTED sampling:
# every moving-PML subgrid H_m samples the identical velocity window, so the
# whole family collapses to ONE subgrid (setup factors one corner inverse;
# the sweep broadcasts it: the shared-G case of the sweep kernel).  Not valid
# for fidelity="as-shipped", whose transposed read makes the sampled velocity
# layer-dependent even for this medium.
ROW_INVARIANT_VELOCITY = frozenset({"c2_f1", "c2_f2"})

# Velocity fields smooth on the scale of a few grid rows (the two reference
# Gaussians, feature scale ~0.18 in unit-square coordinates): the
# precondition for strided factorization with interpolated corner inverses
# (precond.sweeping.factor_corner_inverses).  `run_solver`'s auto
# `factor_stride` applies ONLY to problems in this set.
SMOOTH_VELOCITY = frozenset({"c1_f1", "c1_f2", "c2_f1", "c2_f2"})
