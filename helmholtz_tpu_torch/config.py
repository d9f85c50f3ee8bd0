"""Configuration dataclasses of the PyTorch/CUDA port.

The port's own copy of the JAX package's `config.py`: pure Python, so every
experiment configuration of the reference entry point
``run_solver(n, b, wave_num, const, alpha, ...)`` is expressible verbatim.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Literal

Fidelity = Literal["as-shipped", "corrected"]


@dataclasses.dataclass(frozen=True)
class HelmholtzConfig:
    """Continuous + discrete problem definition.

      n        : interior grid size (N = n**2 unknowns)
      b        : PML width in grid points; eta = b*h
      wave_num : omega / (2*pi)
      const    : PML damping amplitude "C"
      alpha    : imaginary frequency shift; omega = 2*pi*wave_num + i*alpha
    """

    n: int = 127
    b: int = 12
    wave_num: float = 16.0
    const: float = 81.0
    alpha: float = 2.0
    #: "corrected" samples the velocity at the true stencil point
    #: (x1=i*h, x2=j*h); "as-shipped" reproduces the original code's
    #: transposed, one-point-shifted read `c_mat[i-1, j-1]`.
    fidelity: Fidelity = "corrected"

    @property
    def h(self) -> float:
        return 1.0 / (self.n + 1)

    @property
    def eta(self) -> float:
        return self.b * self.h

    @property
    def omega(self) -> complex:
        return 2.0 * math.pi * self.wave_num + 1j * self.alpha

    @property
    def num_unknowns(self) -> int:
        return self.n * self.n


@dataclasses.dataclass(frozen=True)
class SolverConfig:
    """Krylov solver settings.

    rtol follows legacy scipy `tol`: convergence is declared on the
    *preconditioned* residual norm relative to the preconditioned RHS norm.
    """

    method: Literal["gmres", "bicgstab"] = "gmres"
    restart: int = 20
    rtol: float = 1e-3
    maxiter: int = 10_000
    #: record the per-iteration (preconditioned) residual history
    record_history: bool = True


@dataclasses.dataclass(frozen=True)
class PrecondConfig:
    """Sweeping-preconditioner settings."""

    kind: Literal["none", "moving_pml", "exact"] = "moving_pml"
    #: "corrected" implements Engquist-Ying Algorithms 2.3/2.4 as published;
    #: "as-shipped" reproduces the original code's D2/D3 deviations.
    algorithm_fidelity: Fidelity = "corrected"
    #: upper bound on the number of subgrids factored per batched inverse
    #: (bounds peak memory: a few chunk * n^2 complex words of workspace);
    #: the value of precond.sweeping.DEFAULT_SETUP_CHUNK.
    setup_chunk: int = 256
