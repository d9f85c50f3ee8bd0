"""The high-level entry point `run_solver`: the end-to-end preconditioned solve.

Three eager stages (assemble, factor, solve) on one device.  On the card
every operator product goes through the stencil kernel and every sweep
through the sweep kernel (`ops.kernels`); on the CPU, which the caller must
ask for, the same wrappers run their plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ._device import resolve_device
from .core.sparse import Stencil5
from .fd import problems as fd_problems
from .fd import stencil as fd_stencil
from .ops.kernels.spmv_stencil import stencil_matvec_flat
from .precond.sweeping import (DEFAULT_SETUP_CHUNK, SweepingPreconditioner,
                               setup_preconditioner)
from .solve.gmres import KrylovResult, gmres


def default_complex_dtype(device="cuda") -> torch.dtype:
    """complex64 in flight on the card; complex128 on the CPU (the oracle
    configuration)."""
    return (torch.complex128 if torch.device(device).type == "cpu"
            else torch.complex64)


def auto_factor_stride(n: int, problem: str, device="cuda") -> int:
    """Default `factor_stride` when the caller passes None.

    Strided factorization replaces exact corner inverses with linear
    interpolation between every stride-th subgrid, valid only for velocity
    fields smooth on the scale of `stride` grid rows
    (precond.sweeping.factor_corner_inverses).  The auto default therefore
    applies ONLY to the builtin problems verified smooth
    (fd.problems.SMOOTH_VELOCITY); any other problem gets exact stride 1
    unless the caller opts in with an explicit factor_stride.

    On the card the stride is clip(n // 128, 1, 8), the reference
    package's formula, which gives 7 at n = 1023; PERF.md records the
    iteration count measured with it on the H100.  On the CPU (the oracle
    configuration) the stride is 1.
    """
    if (torch.device(device).type == "cuda"
            and problem in fd_problems.SMOOTH_VELOCITY):
        return max(1, min(8, n // 128))
    return 1


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _assemble_stage(wave_num, const, alpha, *, n, b, problem, fidelity,
                    cdtype, dedup_hm=False, device):
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    eta = b * h
    c_full, f_grid = fd_problems.PROBLEMS[problem](
        omega, n, complex_dtype=cdtype, device=device)
    A = fd_stencil.build_a_stencil(n, b, const, eta, omega, h, c_full,
                                   fidelity=fidelity, complex_dtype=cdtype)
    if dedup_hm:
        # row-invariant velocity (problems.ROW_INVARIANT_VELOCITY): every
        # H_m is the same matrix, so build/factor ONE and let the sweep
        # broadcast it (shared G).  Setup drops from n-b corner inversions
        # to one; the apply's G traffic drops from (M, n, n) to (1, n, n).
        hm = fd_stencil.build_hm_stencils_rows(
            torch.arange(b, b + 1, device=device), n, b, const, eta, omega,
            h, c_full, fidelity=fidelity, complex_dtype=cdtype)
    else:
        hm = fd_stencil.build_hm_stencils(n, b, const, eta, omega, h, c_full,
                                          fidelity=fidelity,
                                          complex_dtype=cdtype)
    return A, hm, f_grid.to(cdtype)


_G_DTYPES = {"working": None, "f32": torch.float32, "bf16": torch.bfloat16}


def _factor_stage(A, hm, *, b, hf_full_coupling, d2_replace, setup_chunk,
                  g_dtype="working", factor_stride=1, g_compress=False,
                  device):
    return setup_preconditioner(A, hm, b, hf_full_coupling=hf_full_coupling,
                                d2_replace=d2_replace,
                                setup_chunk=setup_chunk,
                                g_dtype=_G_DTYPES[g_dtype],
                                factor_stride=factor_stride,
                                g_compress=g_compress, device=device)


def _solve_stage(A: Stencil5, P: Optional[SweepingPreconditioner],
                 f: torch.Tensor, rtol, *, restart, maxiter, use_precond,
                 method="gmres", precond_refine=0, precision="f32",
                 device) -> KrylovResult:
    if precision == "ir-df32":
        raise NotImplementedError(
            "precision='ir-df32' belongs to the precision slice of the "
            "port (solve/ir), which is not ported yet")
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r}")
    if method == "bicgstab":
        raise NotImplementedError(
            "method='bicgstab' belongs to the solver-extras slice of the "
            "port, which is not ported yet")
    if method != "gmres":
        raise ValueError(f"unknown method {method!r}")

    mv = lambda v: stencil_matvec_flat(A, v)
    M = P if use_precond else None
    if use_precond and precond_refine:
        # Iterative refinement of the preconditioner solve:
        # M_k+1 = M_k + M (I - A M_k) squares the preconditioner's deviation
        # from A^{-1} per step, compensating a reduced-precision G stack.
        M0 = P

        def M(v):
            u = M0(v)
            for _ in range(precond_refine):
                u = u + M0(v - mv(u))
            return u

    return gmres(mv, f.reshape(-1), M=M, restart=restart, rtol=rtol,
                 maxiter=maxiter, device=device)


@dataclasses.dataclass
class SolveReport:
    """Host-side result record."""

    u: np.ndarray                 # solution on the (n, n) grid, complex
    iterations: int
    converged: bool
    residual_norm: float          # final preconditioned residual
    true_residual: float          # ||A u - f|| / ||f|| (recomputed)
    history: np.ndarray           # per-iteration preconditioned residuals
    init_time: float              # assembly + factorization
    solve_time: float
    config: dict

    def metrics(self) -> dict:
        return {
            "iterations": self.iterations,
            "converged": self.converged,
            "true_residual": self.true_residual,
            "init_time_s": self.init_time,
            "solve_time_s": self.solve_time,
            **self.config,
        }


@torch.no_grad()
def run_solver(n: int, b: int, wave_num: float, const: float,
               alpha: float = 2.0, problem: str = "c1_f1", *,
               rtol: float = 1e-3, restart: int = 20,
               maxiter: Optional[int] = None,
               method: str = "gmres",
               precond: str = "moving_pml",
               stencil: str = "5pt",
               precond_refine: int = 0,
               precision: str = "f32",
               g_dtype: str = "working",
               fidelity: str = "corrected",
               hf_full_coupling: bool = True,
               d2_replace: bool = True,
               setup_chunk: int = DEFAULT_SETUP_CHUNK,
               factor_stride: Optional[int] = None,
               g_compress: bool = False,
               dedup_hm: Optional[bool] = None,
               complex_dtype=None,
               device="cuda") -> SolveReport:
    """End-to-end preconditioned solve on `device`.

    `factor_stride` None = auto (`auto_factor_stride`): on the card, factor
    every clip(n//128, 1, 8)-th subgrid and interpolate; exact stride 1 on
    the CPU and always available via factor_stride=1.

    With the default device and no card this raises; the CPU is used only
    when asked for.
    """
    dev = resolve_device(device)
    if stencil != "5pt":
        raise NotImplementedError(
            f"stencil={stencil!r}: only the 5-point scheme is ported yet")
    if precond not in ("moving_pml", "none"):
        raise NotImplementedError(
            f"precond={precond!r}: only 'moving_pml' and 'none' are ported "
            "yet")
    # Full-float32 products everywhere: TF32 in the Schur recursion's
    # scalings, the block-Thomas solves or the Arnoldi products costs GMRES
    # iterations (the reference package pins its highest precision for the
    # same reason).
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32
    cdtype = complex_dtype or default_complex_dtype(dev)
    maxiter = maxiter if maxiter is not None else (200 if precond != "none"
                                                  else 20_000)
    if dedup_hm is None:
        dedup_hm = (problem in fd_problems.ROW_INVARIANT_VELOCITY
                    and fidelity == "corrected")
    if factor_stride is None:
        factor_stride = auto_factor_stride(n, problem, dev)
    if dedup_hm:
        factor_stride = 1

    _sync(dev)
    t0 = time.perf_counter()
    A, hm, f_grid = _assemble_stage(
        wave_num, const, alpha, n=n, b=b, problem=problem, fidelity=fidelity,
        cdtype=cdtype, dedup_hm=dedup_hm, device=dev)
    use_precond = precond != "none"
    P = None
    if use_precond:
        P = _factor_stage(A, hm, b=b, hf_full_coupling=hf_full_coupling,
                          d2_replace=d2_replace, setup_chunk=setup_chunk,
                          g_dtype=g_dtype, factor_stride=factor_stride,
                          g_compress=g_compress, device=dev)
    del hm
    _sync(dev)
    t1 = time.perf_counter()

    res = _solve_stage(A, P, f_grid, rtol, restart=restart, maxiter=maxiter,
                       use_precond=use_precond, method=method,
                       precond_refine=precond_refine, precision=precision,
                       device=dev)
    _sync(dev)
    t2 = time.perf_counter()

    u = res.x.cpu().numpy().reshape(n, n)
    f_np = f_grid.cpu().numpy().reshape(-1)
    # true residual via the host SpMV on the assembled operator
    Au = _host_stencil_matvec(A.to_numpy(), u)
    true_res = float(np.linalg.norm(Au.reshape(-1) - f_np)
                     / np.linalg.norm(f_np))
    history = res.history[~np.isnan(res.history)]

    return SolveReport(
        u=u,
        iterations=int(res.iterations),
        converged=bool(res.converged),
        residual_norm=float(res.residual_norm),
        true_residual=true_res,
        history=history,
        init_time=t1 - t0,
        solve_time=t2 - t1,
        config=dict(n=n, b=b, wave_num=wave_num, const=const, alpha=alpha,
                    problem=problem, rtol=rtol, restart=restart,
                    method=method, precond=precond, fidelity=fidelity,
                    precond_refine=precond_refine, precision=precision,
                    g_dtype=g_dtype, factor_stride=factor_stride,
                    g_compress=g_compress, dedup_hm=dedup_hm,
                    dtype=str(cdtype).replace("torch.", ""),
                    device=str(dev)),
    )


def _host_stencil_matvec(A_np, u):
    """Numpy stencil apply for host-side residual verification; A_np is the
    (cc, cw, ce, cs, cn) tuple of numpy fields."""
    cc, cw, ce, cs, cn = A_np
    out = cc * u
    out[:, 1:] += cw[:, 1:] * u[:, :-1]
    out[:, :-1] += ce[:, :-1] * u[:, 1:]
    out[1:, :] += cs[1:, :] * u[:-1, :]
    out[:-1, :] += cn[:-1, :] * u[1:, :]
    return out
