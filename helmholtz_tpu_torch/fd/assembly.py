"""Problem assembly: config -> operator + RHS."""
from __future__ import annotations

import dataclasses

import torch

from .._device import resolve_device
from ..config import HelmholtzConfig
from ..core.sparse import Stencil5
from . import problems, stencil


@dataclasses.dataclass(frozen=True)
class Problem:
    """Assembled discrete problem: operator A (Stencil5 on the (n, n) grid),
    velocity field on the full grid, and forcing on the interior grid."""

    A: Stencil5
    c_full: torch.Tensor   # (n+2, n+2) real
    f_grid: torch.Tensor   # (n, n) complex

    @property
    def f_vec(self) -> torch.Tensor:
        return self.f_grid.reshape(-1)


@torch.no_grad()
def assemble_problem(cfg: HelmholtzConfig, problem: str = "c1_f1",
                     complex_dtype=None, *, device="cuda") -> Problem:
    """Build velocity, forcing, and the global operator for a named problem
    instance.  `complex_dtype` defaults to complex64 on the card and
    complex128 on the CPU."""
    dev = resolve_device(device)
    if complex_dtype is None:
        complex_dtype = (torch.complex64 if dev.type == "cuda"
                         else torch.complex128)
    init = problems.PROBLEMS[problem]
    c_full, f_grid = init(cfg.omega, cfg.n, complex_dtype=complex_dtype,
                          device=dev)
    A = stencil.build_a_stencil(
        cfg.n, cfg.b, cfg.const, cfg.eta, cfg.omega, cfg.h, c_full,
        fidelity=cfg.fidelity, complex_dtype=complex_dtype)
    return Problem(A=A, c_full=c_full, f_grid=f_grid.to(complex_dtype))


def interlayer_couplings(A: Stencil5):
    """The diagonal interlayer coupling vectors used by the sweep.

    Returns (down, up) of shape (L, n):
      down[j] = the diagonal of block A_{j, j-1} (coupling to layer below)
              = A.cs[j];
      up[j]   = the diagonal of block A_{j, j+1} = A.cn[j].
    """
    return A.cs, A.cn
