"""GMRES over the bands: the distributed preconditioned solve.

Every rank runs the port's lockstep GMRES (`solve.gmres.gmres_batched`) on
its band of the vectors.  The operator product is the halo-exchange band
product (`dist.spmv`), the preconditioner the staged sweep
(`dist.sweep`), and every inner product and norm is summed over the ranks
(`dist.comm.allreduce_sum`) before the host uses it, so each rank takes
the same branch at every convergence, breakdown and restart test.  Vectors,
stencil fields and G stay on their rank for the whole solve; no rank ever
holds a global vector.

`precision="ir-df32"` is the port's refinement (`solve.ir`) with a
halo-exchanged complex128 residual (`dist.spmv.halo_matvec_hi`), the
counterpart of the JAX package's halo-exchanged compensated residual.
`precond_refine` applies the preconditioner's Newton refinement as the
single-card solve does.  A batch of right-hand sides (B, n_loc, n) steps
in lockstep, every preconditioner apply one staged schedule and one pass
of each band's G for the members still iterating.
"""
from __future__ import annotations

import torch

from ..core.sparse import Stencil9
from ..ops import spmv as plain_spmv
from ..solve.gmres import KrylovResult, first_member, gmres_batched
from ..solve.ir import ir_gmres_batched
from . import comm
from .spmv import (halo_matvec, halo_matvec_hi, halo_stencil9_matvec,
                   halo_stencil_matvec)
from .sweep import dist_apply_preconditioner


def distributed_solve(mesh, A_band, state, f_band: torch.Tensor, *,
                      rtol: float = 1e-3, restart: int = 20,
                      maxiter: int = 200, precision: str = "f32",
                      precond_refine: int = 0,
                      inner_rtol: float = 1e-2) -> KrylovResult:
    """Distributed GMRES on this rank's band; every rank of the mesh calls
    it with its own band of the same problem.

    A_band: the band's Stencil5 or Stencil9 (n_loc, n); state: the band's
    `DistSweepState` / `DistSweepState9` or None (no preconditioner);
    f_band: (n_loc, n), or (B, n_loc, n) for a batch.  Returns a
    KrylovResult whose `x` is this rank's band of the flat solution(s)
    ((n_loc * n,) or (B, n_loc * n)); the scalars are the same on every
    rank.  Needs b < n_loc: the F band lives on rank 0.
    """
    from ..driver import _refined

    n_loc, n = A_band.grid_shape
    if state is not None and state.b >= n_loc:
        raise ValueError(f"PML width b={state.b} must be < rows-per-device "
                         f"{n_loc}")
    if precision not in ("f32", "ir-df32"):
        raise ValueError(f"unknown precision {precision!r}")
    batched = f_band.ndim == 3
    F = (f_band if batched else f_band[None]).reshape(-1, n_loc * n)
    grid = lambda V: V.reshape(-1, n_loc, n)

    def mv(V):
        return halo_matvec(mesh, A_band, grid(V)).reshape(V.shape)

    M = None
    if state is not None:
        M = _refined(lambda V: dist_apply_preconditioner(
            mesh, state, grid(V)).reshape(V.shape), mv,
            precond_refine)
    allreduce = lambda t: comm.allreduce_sum(mesh, t)
    if precision == "ir-df32":
        res = ir_gmres_batched(
            mv, lambda X: halo_matvec_hi(mesh, A_band, grid(X)).reshape(
                X.shape), F, M=M, rtol=rtol, restart=restart,
            maxiter=maxiter, inner_rtol=inner_rtol, allreduce=allreduce,
            device=mesh.device)
    else:
        res = gmres_batched(mv, F, M=M, restart=restart, rtol=rtol,
                            maxiter=maxiter, allreduce=allreduce,
                            device=mesh.device)
    return res if batched else first_member(res)


def band_true_residuals(mesh, A_band, X_band: torch.Tensor,
                        F_band: torch.Tensor) -> list:
    """||A x - f|| / ||f|| per member of a batch of band solutions (B,
    n_loc, n), in the working precision on the host, each rank's sums of
    squares summed over the ranks: the distributed counterpart of the
    host residual in `driver._multisolve_record`."""
    if isinstance(A_band, Stencil9):
        Y = halo_stencil9_matvec(mesh, A_band, X_band)
    else:       # plain tensor code: no kernel launch outside the solve
        Y = halo_stencil_matvec(mesh, A_band, X_band,
                                interior=plain_spmv.stencil_matvec)
    R = (Y - F_band).reshape(F_band.shape[0], -1)
    sums = torch.stack([torch.sum(R.real ** 2 + R.imag ** 2, dim=-1),
                        torch.sum(F_band.reshape(F_band.shape[0], -1).abs()
                                  ** 2, dim=-1)])
    sums = comm.allreduce_sum(mesh, sums.to(torch.float64)).cpu().numpy()
    return [float((r / f) ** 0.5) for r, f in zip(sums[0], sums[1])]

