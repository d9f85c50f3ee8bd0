"""The high-level entry points: `run_solver`, the end-to-end preconditioned
solve, and `run_multisolve`, many sources and many frequencies against one
operator each.

Eager stages (assemble, factor, solve) on one device.  On the card every
5-point operator product goes through the stencil kernel, every sweep,
5-point or 9-point, through the sweep kernel, and every setup's inverses
through the Gauss-Jordan kernel at the base of the blocked inverse
(`ops.kernels`, `ops.dense`).  On the CPU, which the caller must ask for,
the wrappers run their plain PyTorch versions and the inverses are
`torch.linalg.inv`.  The 9-point operator product (`stencil="9pt"`) is
plain tensor code on either device, as the JAX package leaves it to its
compiler.  `precond="recompute"` keeps no factor stack: every apply
re-factors the subgrids chunk by chunk (the Gauss-Jordan kernel) and sweeps
each chunk (the sweep kernel).  The stages carry `utils.profiling.phase`
ranges ("assemble", "factor", "solve") for a `torch.profiler` trace.
"""
from __future__ import annotations

import dataclasses
import math
import os
import time
from typing import Optional

import numpy as np
import torch

from ._device import real_dtype_of, resolve_device
from .core.sparse import Stencil9
from .fd import problems as fd_problems
from .fd import stencil as fd_stencil
from .ops import spmv as plain_spmv
from .ops.kernels.spmv_stencil import stencil_matvec_flat
from .precond.exact import factor_exact
from .precond.recompute import (RecomputeSweepingPreconditioner,
                                setup_recompute)
from .precond.sweeping import (DEFAULT_SETUP_CHUNK,
                               preconditioner_from_samples,
                               setup_preconditioner)
from .precond.sweeping9 import (preconditioner_from_samples9,
                                setup_preconditioner9,
                                setup_preconditioner9_assembling)
from .solve.batched import solve_multi_rhs
from .solve.bicgstab import bicgstab
from .solve.gmres import KrylovResult, gmres
from .solve.ir import ir_gmres, ir_gmres_batched
from .utils.profiling import phase


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


def min_pml_width9(n: int) -> int:
    """Minimum moved-PML depth for the 9-POINT sweeping preconditioner.

    The 9-point subgrid needs a WIDER moved PML than the 5-point scheme's
    b = 12: the tapered diagonal branch leaves only the 5-point part
    absorbing, so the layer must be deeper; b about n/14 keeps iteration
    counts flat (`precond.sweeping9`).  No lower floor: at small sizes
    (n <= ~170) any b works and tiny test grids use b < 12."""
    return -(-n // 14)


def _check_pml_width9(n: int, b: int) -> None:
    """Refuse NOISILY when a 9-point solve is configured with a PML too
    thin for its preconditioner to converge.  b is a property of the
    PROBLEM (eta = b*h shapes the global operator), so it is never widened
    behind the caller's back; the guard raises with the recipe instead.
    HELMHOLTZ_TPU_9PT_ALLOW_THIN_PML=1 opts into the thin-PML configuration
    for experimentation."""
    need = min_pml_width9(n)
    if b >= need or os.environ.get("HELMHOLTZ_TPU_9PT_ALLOW_THIN_PML"):
        return
    raise ValueError(
        f"stencil='9pt' with PML width b={b} at n={n}: the 9-point "
        f"sweeping preconditioner needs b >= ~n/14 = {need} (measured: "
        f"at the 5-point default b=12 the n=511 solve does not converge "
        f"in 100 iterations; precond.sweeping9 docstring).  Pass "
        f"b={need} (with C ~ 60), or set "
        f"HELMHOLTZ_TPU_9PT_ALLOW_THIN_PML=1 to force this b.")


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _set_full_float32() -> None:
    """Full-float32 products everywhere: TF32 in the Schur recursion's
    scalings, the block-Thomas solves (matrix products once the right-hand
    sides are batched) or the Arnoldi products costs GMRES iterations (the
    reference package pins its highest precision for the same reason)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    assert not torch.backends.cuda.matmul.allow_tf32


def multisolve_key_config(n: int, b: int, problem: str, rtol: float,
                          n_sources: int, *, fidelity: str = "corrected",
                          g_dtype: str = "working",
                          factor_stride: Optional[int] = None,
                          g_compress: bool = False,
                          freq_anchor_every: int = 1,
                          precond: str = "moving_pml",
                          stencil: str = "5pt",
                          stencil_gamma: float = 2.0 / 3.0,
                          mesh_devices: Optional[int] = None,
                          precision: str = "f32",
                          precond_refine: int = 0,
                          device="cuda") -> dict:
    """The normalized run-defining configuration of a `run_multisolve`
    call: the identity under which a sweep's records may be resumed.
    Included verbatim in every record `run_multisolve` emits, so a record
    written under one discretization / preconditioner / precision can never
    satisfy a resume under another.  `device` only resolves the auto
    `factor_stride` and is no key."""
    if factor_stride is None:
        factor_stride = auto_factor_stride(n, problem, device)
    return {
        "n": n, "b": b, "problem": problem, "rtol": rtol,
        "n_sources": n_sources, "fidelity": fidelity, "stencil": stencil,
        "stencil_gamma": (float(stencil_gamma) if stencil == "9pt"
                          else None),
        "precond": precond, "precision": precision,
        "precond_refine": int(precond_refine), "g_dtype": g_dtype,
        "factor_stride": int(factor_stride), "g_compress": bool(g_compress),
        "freq_anchor_every": int(freq_anchor_every),
        "mesh_devices": (int(mesh_devices) if mesh_devices else None),
    }


def _assemble_a_stage(wave_num, const, alpha, *, n, b, problem, fidelity,
                      cdtype, device):
    """Assemble ONLY the global operator A (no subgrid family): the cheap
    per-frequency work of an omega-amortized sweep, where the H_m factor
    samples come from anchor frequencies instead of a fresh factorization.
    Returns (A, c_full, f_grid)."""
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    eta = b * h
    c_full, f_grid = fd_problems.PROBLEMS[problem](
        omega, n, complex_dtype=cdtype, device=device)
    A = fd_stencil.build_a_stencil(n, b, const, eta, omega, h, c_full,
                                   fidelity=fidelity, complex_dtype=cdtype)
    return A, c_full, f_grid


def _assemble_stage(wave_num, const, alpha, *, n, b, problem, fidelity,
                    cdtype, dedup_hm=False, device):
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    eta = b * h
    A, c_full, f_grid = _assemble_a_stage(
        wave_num, const, alpha, n=n, b=b, problem=problem, fidelity=fidelity,
        cdtype=cdtype, device=device)
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


def _assemble_a9_stage(wave_num, const, alpha, gamma, *, n, b, problem,
                       fidelity, cdtype, device):
    """Assemble ONLY the 9-point global operator (no subgrid family): the
    cheap per-frequency work of an omega-amortized 9-point sweep.  Returns
    (A9, c_full, f_grid); f_grid is the raw forcing, not yet filtered."""
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    eta = b * h
    c_full, f_grid = fd_problems.PROBLEMS[problem](
        omega, n, complex_dtype=cdtype, device=device)
    A9 = fd_stencil.build_a_stencil9(n, b, const, eta, omega, h, c_full,
                                     gamma=gamma, fidelity=fidelity,
                                     complex_dtype=cdtype)
    return A9, c_full, f_grid


def _mass_filter9_stage(F, wave_num, const, alpha, *, n, b):
    """Apply the Mehrstellen right-hand-side filter to a (batch of) forcing
    grid(s) (`fd.stencil.mass_filter9`): the compact scheme solves
    A9 u = M f, so the filtered forcing is the system's right-hand side and
    the one the true residual is taken against."""
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    return fd_stencil.mass_filter9(n, b, const, b * h, omega, h, F)


def _setup9_stage(wave_num, const, alpha, gamma, *, n, b, problem, fidelity,
                  cdtype, device, factor_stride, g_dtype="working",
                  d2_replace=True, setup_chunk=DEFAULT_SETUP_CHUNK,
                  g_compress=False, use_precond=True):
    """9-point assembly + factorization of one frequency: returns (A9,
    filtered forcing grid, preconditioner or None).

    A SAMPLED setup (factor_stride > 1 on more than factor_stride sweep
    rows) assembles the sample subgrids chunk by chunk inside the factor
    loop (`precond.sweeping9.setup_preconditioner9_assembling`), so the
    nine-field family exists one chunk at a time; the exact stride-1 setup
    assembles the whole family and then factors it."""
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    eta = b * h
    A9, c_full, f_grid = _assemble_a9_stage(
        wave_num, const, alpha, gamma, n=n, b=b, problem=problem,
        fidelity=fidelity, cdtype=cdtype, device=device)
    f9 = _mass_filter9_stage(f_grid.to(cdtype), wave_num, const, alpha,
                             n=n, b=b)
    if not use_precond:
        return A9, f9, None
    common = dict(d2_replace=d2_replace, setup_chunk=setup_chunk,
                  g_dtype=_G_DTYPES[g_dtype], factor_stride=factor_stride)
    if factor_stride > 1 and (n - b) > factor_stride:
        P = setup_preconditioner9_assembling(
            A9, b, const, eta, omega, h, c_full, gamma=gamma,
            fidelity=fidelity, g_compress=g_compress, **common)
    else:
        hm9 = fd_stencil.build_hm_stencils9(
            n, b, const, eta, omega, h, c_full, gamma=gamma,
            fidelity=fidelity, complex_dtype=cdtype)
        P = setup_preconditioner9(A9, hm9, b, device=device, **common)
    return A9, f9, P


def _factor_stage(A, hm, *, b, hf_full_coupling, d2_replace, setup_chunk,
                  g_dtype="working", factor_stride=1, g_compress=False,
                  device):
    return setup_preconditioner(A, hm, b, hf_full_coupling=hf_full_coupling,
                                d2_replace=d2_replace,
                                setup_chunk=setup_chunk,
                                g_dtype=_G_DTYPES[g_dtype],
                                factor_stride=factor_stride,
                                g_compress=g_compress, device=device)


def _factor_recompute_stage(A, c_full, wave_num, const, alpha, *, n, b,
                            fidelity, hf_full_coupling, d2_replace,
                            factor_stride=1):
    """Factor-free setup (precond='recompute'): only H_F is factored; the
    G stack is re-derived chunk by chunk inside every apply
    (`precond.recompute`), which removes the O(M n^2) factor memory."""
    return setup_recompute(n, b, wave_num, const, alpha, c_full, A=A,
                           fidelity=fidelity,
                           hf_full_coupling=hf_full_coupling,
                           d2_replace=d2_replace, chunk=None,
                           factor_stride=factor_stride)


def _matvec_of(A):
    """The operator product on one flat vector: the stencil kernel's
    wrapper for a Stencil5, plain tensor code for a Stencil9."""
    if isinstance(A, Stencil9):
        return lambda v: plain_spmv.stencil9_matvec_flat(A, v)
    return lambda v: stencil_matvec_flat(A, v)


def _solve_stage(A, P, f: torch.Tensor, rtol, *, restart, maxiter,
                 use_precond,
                 method="gmres", precond_refine=0, precision="f32",
                 inner_rtol=1e-2, device) -> KrylovResult:
    if precision not in ("f32", "ir-df32"):
        raise ValueError(f"unknown precision {precision!r}")
    if method not in ("gmres", "bicgstab"):
        raise ValueError(f"unknown method {method!r}")
    if method == "bicgstab" and precision == "ir-df32":
        raise ValueError("ir-df32 precision requires method='gmres'")

    mv = _matvec_of(A)
    M = _refined(P, mv, precond_refine) if use_precond else None
    if method == "bicgstab":
        return bicgstab(mv, f.reshape(-1), M=M, rtol=rtol, maxiter=maxiter,
                        device=device)
    if precision == "ir-df32":
        # complex128 solution carry + complex128 residual: the path that
        # actually reaches rtol 1e-6 with a complex64 operator and M
        return ir_gmres(mv, _matvec_hi(A), f.reshape(-1), M=M, rtol=rtol,
                        restart=restart, maxiter=maxiter,
                        inner_rtol=inner_rtol, device=device)
    return gmres(mv, f.reshape(-1), M=M, restart=restart, rtol=rtol,
                 maxiter=maxiter, device=device)


def _matvec_hi(A):
    """The operator product in complex128 on A's own coefficients, widened:
    (..., N) -> (..., N), plain PyTorch, for either stencil.  What the
    refinement's residual b - A x is computed with."""
    A_hi = A.map(lambda f: f.to(torch.complex128))
    flat = (plain_spmv.stencil9_matvec_flat if isinstance(A, Stencil9)
            else plain_spmv.stencil_matvec_flat)
    return lambda x: flat(A_hi, x)


def _refined(M0, mv, precond_refine: int):
    """Iterative refinement of the preconditioner solve:
    M_k+1 = M_k + M (I - A M_k) squares the preconditioner's deviation from
    A^{-1} per step, compensating a reduced-precision G stack."""
    if not precond_refine:
        return M0

    def M(v):
        u = M0(v)
        for _ in range(precond_refine):
            u = u + M0(v - mv(u))
        return u

    return M


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
               stencil_gamma: float = 2.0 / 3.0,
               precond_refine: int = 0,
               precision: str = "f32",
               inner_rtol: float = 1e-2,
               g_dtype: str = "working",
               fidelity: str = "corrected",
               hf_full_coupling: bool = True,
               d2_replace: bool = True,
               setup_chunk: int = DEFAULT_SETUP_CHUNK,
               factor_stride: Optional[int] = None,
               g_compress: bool = False,
               dedup_hm: Optional[bool] = None,
               complex_dtype=None,
               plot_solution: bool = False,
               device="cuda") -> SolveReport:
    """End-to-end preconditioned solve on `device`.

    `factor_stride` None = auto (`auto_factor_stride`): on the card, factor
    every clip(n//128, 1, 8)-th subgrid and interpolate; exact stride 1 on
    the CPU and always available via factor_stride=1.

    `precond="exact"` factors the whole 5-point operator exactly
    (`precond.exact`): GMRES then converges in one or two iterations, and
    the setup is L layer inverses and an (L, n, n) stack, the validation
    oracle rather than a production setting.

    `precond="recompute"` (5-point) factors only H_F and re-derives the
    corner inverses chunk by chunk inside every apply
    (`precond.recompute`): O(n^2) memory at rest, about twice the setup's
    factorization work per apply.

    `method="bicgstab"` solves with BiCGStab (`solve.bicgstab`) in place of
    GMRES, on either stencil; `plot_solution=True` draws Re(u) with
    `viz.plot_solution` (needs matplotlib).

    `stencil="9pt"` solves the compact 9-point discretization
    (`fd.stencil.build_a_stencil9`, blend `stencil_gamma`) with its own
    moving-PML sweeping preconditioner (`precond.sweeping9`); it needs a
    PML of b >= ~n/14 layers and takes neither `dedup_hm` nor
    `hf_full_coupling=False`, which are features of the 5-point path.

    With the default device and no card this raises; the CPU is used only
    when asked for.
    """
    dev = resolve_device(device)
    if stencil not in ("5pt", "9pt"):
        raise ValueError(f"unknown stencil {stencil!r}")
    if precond not in ("moving_pml", "recompute", "exact", "none"):
        raise ValueError(f"unknown precond {precond!r}")
    _set_full_float32()
    cdtype = complex_dtype or default_complex_dtype(dev)
    maxiter = maxiter if maxiter is not None else (200 if precond != "none"
                                                  else 20_000)
    if stencil == "9pt":
        # reject options the 9-point path does not implement rather than
        # silently dropping them
        bad = [k for k, v, default in (("dedup_hm", dedup_hm, None),
                                       ("hf_full_coupling",
                                        hf_full_coupling, True))
               if v != default]
        if bad:
            raise ValueError(f"stencil='9pt' does not support {bad} "
                             "(5-point-path features)")
        if precond in ("exact", "recompute"):
            raise ValueError(f"stencil='9pt' supports precond='moving_pml' "
                             f"or 'none', got {precond!r}")
        if precond == "moving_pml":
            _check_pml_width9(n, b)
        if factor_stride is None:
            factor_stride = auto_factor_stride(n, problem, dev)
        return _run_solver9(
            n, b, wave_num, const, alpha, problem, rtol=rtol,
            restart=restart, maxiter=maxiter, method=method, precond=precond,
            g_dtype=g_dtype, fidelity=fidelity, d2_replace=d2_replace,
            setup_chunk=setup_chunk, factor_stride=factor_stride,
            gamma=stencil_gamma, cdtype=cdtype, g_compress=g_compress,
            precision=precision, precond_refine=precond_refine,
            inner_rtol=inner_rtol, plot_solution=plot_solution, device=dev)
    if dedup_hm is None:
        dedup_hm = (problem in fd_problems.ROW_INVARIANT_VELOCITY
                    and fidelity == "corrected")
    if factor_stride is None:
        factor_stride = auto_factor_stride(n, problem, dev)
    if dedup_hm:
        factor_stride = 1

    _sync(dev)
    t0 = time.perf_counter()
    use_precond = precond != "none"
    P = None
    if precond == "moving_pml":
        with phase("assemble"):
            A, hm, f_grid = _assemble_stage(
                wave_num, const, alpha, n=n, b=b, problem=problem,
                fidelity=fidelity, cdtype=cdtype, dedup_hm=dedup_hm,
                device=dev)
        with phase("factor"):
            P = _factor_stage(A, hm, b=b, hf_full_coupling=hf_full_coupling,
                              d2_replace=d2_replace, setup_chunk=setup_chunk,
                              g_dtype=g_dtype, factor_stride=factor_stride,
                              g_compress=g_compress, device=dev)
        del hm
    else:
        with phase("assemble"):
            A, c_full, f_grid = _assemble_a_stage(
                wave_num, const, alpha, n=n, b=b, problem=problem,
                fidelity=fidelity, cdtype=cdtype, device=dev)
            f_grid = f_grid.to(cdtype)
        with phase("factor"):
            if precond == "exact":
                P = factor_exact(A)
            elif precond == "recompute":
                P = _factor_recompute_stage(
                    A, c_full, wave_num, const, alpha, n=n, b=b,
                    fidelity=fidelity, hf_full_coupling=hf_full_coupling,
                    d2_replace=d2_replace, factor_stride=factor_stride)
    _sync(dev)
    t1 = time.perf_counter()

    with phase("solve"):
        res = _solve_stage(A, P, f_grid, rtol, restart=restart,
                           maxiter=maxiter, use_precond=use_precond,
                           method=method, precond_refine=precond_refine,
                           precision=precision, inner_rtol=inner_rtol,
                           device=dev)
    _sync(dev)
    t2 = time.perf_counter()

    report = _solve_report(
        A, f_grid, res, n, init_time=t1 - t0, solve_time=t2 - t1,
        config=dict(n=n, b=b, wave_num=wave_num, const=const, alpha=alpha,
                    problem=problem, rtol=rtol, restart=restart,
                    method=method, precond=precond, fidelity=fidelity,
                    precond_refine=precond_refine, precision=precision,
                    g_dtype=g_dtype, factor_stride=factor_stride,
                    g_compress=g_compress, dedup_hm=dedup_hm,
                    dtype=str(cdtype).replace("torch.", ""),
                    device=str(dev)))
    if plot_solution:
        from . import viz
        viz.plot_solution(report)
    return report


def _solve_report(A, f_grid, res: KrylovResult, n, *, init_time, solve_time,
                  config) -> SolveReport:
    """The host-side record of one solve; the true residual is recomputed
    with the host product on the assembled operator (either stencil)."""
    u = res.x.cpu().numpy().reshape(n, n)
    f_np = f_grid.cpu().numpy().reshape(-1)
    Au = _host_matvec_any(A.to_numpy(), u)
    true_res = float(np.linalg.norm(Au.reshape(-1) - f_np)
                     / np.linalg.norm(f_np))
    return SolveReport(
        u=u, iterations=int(res.iterations), converged=bool(res.converged),
        residual_norm=float(res.residual_norm), true_residual=true_res,
        history=res.history[~np.isnan(res.history)], init_time=init_time,
        solve_time=solve_time, config=config)


def _run_solver9(n, b, wave_num, const, alpha, problem, *, rtol, restart,
                 maxiter, method, precond, g_dtype, fidelity, d2_replace,
                 setup_chunk, factor_stride, gamma, cdtype, g_compress,
                 precision, precond_refine, inner_rtol, plot_solution=False,
                 device) -> SolveReport:
    """`run_solver` for stencil='9pt': the 9-point discretization solved end
    to end with its own moving-PML sweeping preconditioner."""
    _sync(device)
    t0 = time.perf_counter()
    use_precond = precond != "none"
    # the sampled setup assembles the subgrids inside its factor loop, so
    # one range covers both stages
    with phase("assemble"), phase("factor"):
        A9, f9, P = _setup9_stage(
            wave_num, const, alpha, gamma, n=n, b=b, problem=problem,
            fidelity=fidelity, cdtype=cdtype, device=device,
            factor_stride=factor_stride, g_dtype=g_dtype,
            d2_replace=d2_replace, setup_chunk=setup_chunk,
            g_compress=g_compress, use_precond=use_precond)
    _sync(device)
    t1 = time.perf_counter()
    with phase("solve"):
        res = _solve_stage(A9, P, f9, rtol, restart=restart,
                           maxiter=maxiter, use_precond=use_precond,
                           method=method, precond_refine=precond_refine,
                           precision=precision, inner_rtol=inner_rtol,
                           device=device)
    _sync(device)
    t2 = time.perf_counter()
    sampled = factor_stride > 1 and (n - b) > factor_stride
    report = _solve_report(
        A9, f9, res, n, init_time=t1 - t0, solve_time=t2 - t1,
        config=dict(n=n, b=b, wave_num=wave_num, const=const, alpha=alpha,
                    problem=problem, rtol=rtol, restart=restart,
                    method=method, precond=precond, fidelity=fidelity,
                    stencil="9pt", stencil_gamma=gamma, g_dtype=g_dtype,
                    factor_stride=factor_stride,
                    g_compress=bool(g_compress and sampled),
                    precision=precision, precond_refine=precond_refine,
                    dtype=str(cdtype).replace("torch.", ""),
                    device=str(device)))
    if plot_solution:
        from . import viz
        viz.plot_solution(report)
    return report


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


def _host_stencil9_matvec(A_np, u):
    """Numpy 9-point stencil apply (the 5-point cross + corner couplings)
    for host-side residual verification of the 9-point path; A_np is the
    tuple of nine numpy fields in `Stencil9` order."""
    csw, cse, cnw, cne = A_np[5:]
    out = _host_stencil_matvec(A_np[:5], u)
    out[1:, 1:] += csw[1:, 1:] * u[:-1, :-1]
    out[1:, :-1] += cse[1:, :-1] * u[:-1, 1:]
    out[:-1, 1:] += cnw[:-1, 1:] * u[1:, :-1]
    out[:-1, :-1] += cne[:-1, :-1] * u[1:, 1:]
    return out


def _host_matvec_any(A_np, u):
    """Host stencil apply for either footprint, told apart by the number of
    fields."""
    return (_host_stencil9_matvec(A_np, u) if len(A_np) == 9
            else _host_stencil_matvec(A_np, u))


# -- many sources, many frequencies -------------------------------------------

def _sources_stage(wave_num, alpha, r1s, r2s, *, n, problem, cdtype, device):
    """Batched forcing stage: one RHS per source position, (K, n, n).

    Many shots at one frequency share the operator and the factored
    preconditioner, so the whole batch rides one G stream
    (`ops.kernels.sweep` with R > 1).
    """
    omega = complex(2.0 * math.pi * wave_num, alpha)
    if problem.endswith("f1"):
        mk = lambda r1, r2: fd_problems.init_f1_mat(
            r1, r2, omega, n, complex_dtype=cdtype, device=device)
    else:
        mk = lambda r1, r2: fd_problems.init_f2_mat(
            r1, r2, 2.0 ** -0.5, 2.0 ** -0.5, omega, n,
            complex_dtype=cdtype, device=device)
    return torch.stack([mk(float(r1), float(r2))
                        for r1, r2 in zip(r1s, r2s)])


def _msolve_stage(A, P, F: torch.Tensor,
                  rtol, *, restart, maxiter, method="gmres",
                  precision="f32", precond_refine=0, inner_rtol=1e-2,
                  device) -> KrylovResult:
    """Batched-RHS solve: (K, n, n) right-hand sides through one operator
    and one preconditioner, the batch sharing a single G stream per apply.
    The 5-point operator product runs once per right-hand side (the stencil
    kernel takes one grid); the 9-point one takes the batch as it is.
    `precision="ir-df32"` and `precond_refine` mirror the single-RHS
    `_solve_stage`."""
    K = F.shape[0]
    one = _matvec_of(A)
    mv = one if isinstance(A, Stencil9) else (
        lambda V: torch.stack([one(v) for v in V]))
    M = _refined(P.apply_multi, mv, precond_refine)
    if method == "gmres" and precision == "ir-df32":
        return ir_gmres_batched(mv, _matvec_hi(A), F.reshape(K, -1), M=M,
                                rtol=rtol, restart=restart, maxiter=maxiter,
                                inner_rtol=inner_rtol, device=device)
    if precision != "f32":
        raise ValueError(f"unknown precision {precision!r} "
                         "(ir-df32 requires method='gmres')")
    return solve_multi_rhs(mv, F.reshape(K, -1), M=M, method=method,
                           restart=restart, rtol=rtol, maxiter=maxiter,
                           device=device)


def _g_accounting(P, n, b, g_compress) -> dict:
    """At-rest factor bytes + modeled per-apply G traffic for a stored
    preconditioner: each apply streams the stack twice (fwd + fused
    diag/bwd sweeps); for a compressed stack the model counts BOTH
    bracketing sample panels at every step, that is, no reuse between
    steps."""
    G = P.G_re
    item = G.element_size()
    panels_per_step = 2 if g_compress else 1
    traffic = (2 * (n - b) * panels_per_step * G.shape[-2] * G.shape[-1]
               * item * 2)
    return {
        "g_bytes_at_rest": int(2 * G.numel() * item),
        "g_traffic_gb_per_apply": round(traffic / 1e9, 3),
    }


def _omega_lerp_pair(Ga_re, Ga_im, Gb_re, Gb_im, tau: float):
    """float32-accumulated lerp of two identically laid out factor sample
    stacks, stored back at their own type.  float32 whatever the working
    precision, as in the reference package."""
    t = torch.tensor(tau, dtype=torch.float32, device=Ga_re.device)
    gdt = Ga_re.dtype

    def lerp(a, b_):
        return ((1.0 - t) * a.to(torch.float32)
                + t * b_.to(torch.float32)).to(gdt)

    return lerp(Ga_re, Gb_re), lerp(Ga_im, Gb_im)


def _precond_from_samples_stage(A, P_a, P_b, tau: float, *, b, g_stride,
                                hf_full_coupling=True, d2_replace=True):
    """Preconditioner at an intermediate frequency of an amortized sweep:
    the compressed G sample stack is the omega-LERP of the two bracketing
    anchor stacks (float32 accumulation; same smoothness argument as
    factor_stride: G is as smooth in omega as it is in m), and only H_F is
    actually factored.  Setup cost: one streaming pass over the two anchor
    stacks instead of ~M/stride dense corner factorizations.  The lerp does
    not depend on the stencil; a Stencil9 operator gets the 9-point H_F."""
    G_re, G_im = _omega_lerp_pair(P_a.G_re, P_a.G_im, P_b.G_re, P_b.G_im,
                                  tau)
    if isinstance(A, Stencil9):
        return preconditioner_from_samples9(A, b, G_re, G_im,
                                            g_stride=g_stride,
                                            d2_replace=d2_replace)
    return preconditioner_from_samples(A, b, G_re, G_im, g_stride=g_stride,
                                       hf_full_coupling=hf_full_coupling,
                                       d2_replace=d2_replace)


def _multisolve_record(key_cfg, A, P, res, F, *, wave_num, const, n,
                       n_sources, t0, t1, t2, cdtype, g_compress,
                       g_dtype) -> dict:
    """One frequency's record; true residuals via the host SpMV."""
    A_np = A.to_numpy()
    F_np = F.cpu().numpy().reshape(n_sources, n, n)
    X = res.x.cpu().numpy().reshape(n_sources, n, n)
    true_res = [float(np.linalg.norm(
        (_host_matvec_any(A_np, X[k]) - F_np[k]).ravel())
        / np.linalg.norm(F_np[k].ravel())) for k in range(n_sources)]
    rec = {
        **key_cfg, "wave_num": float(wave_num), "const": float(const),
        "iterations": np.asarray(res.iterations).tolist(),
        "converged": np.asarray(res.converged).tolist(),
        "true_residuals": true_res,
        "init_time_s": t1 - t0, "solve_time_s": t2 - t1,
        "compiled": False,
        "dtype": str(cdtype).replace("torch.", ""),
    }
    if not isinstance(P, RecomputeSweepingPreconditioner):
        # a recompute state has no G stack to account for
        rec.update(_g_accounting(P, n, P.b, g_compress), g_dtype=g_dtype)
    return rec


@torch.no_grad()
def run_multisolve(n: int, b: int, wave_nums, consts=None,
                   alpha: float = 2.0, problem: str = "c1_f1", *,
                   n_sources: int = 1,
                   source_y: float = 0.125,
                   rtol: float = 1e-3, restart: int = 20,
                   maxiter: int = 200,
                   fidelity: str = "corrected",
                   setup_chunk: int = DEFAULT_SETUP_CHUNK,
                   g_dtype: str = "working",
                   factor_stride: Optional[int] = None,
                   g_compress: bool = False,
                   freq_anchor_every: int = 1,
                   precond: str = "moving_pml",
                   stencil: str = "5pt",
                   stencil_gamma: float = 2.0 / 3.0,
                   mesh_devices: Optional[int] = None,
                   precision: str = "f32",
                   precond_refine: int = 0,
                   complex_dtype=None,
                   device="cuda") -> list:
    """Multi-frequency, multi-source sweep.

    Each frequency assembles + factors once and solves all `n_sources`
    right-hand sides (sources at x = linspace(0.2, 0.8, n_sources),
    y = source_y) in ONE batched Krylov solve whose preconditioner
    applications stream the multi-GB G stack once per iteration for the
    whole batch.  Frequencies run sequentially and the previous factor
    stack is dropped before the next one is built, so peak memory stays one
    factor stack.

    `freq_anchor_every=k` > 1 AMORTIZES setup across the sweep: only every
    k-th frequency of the ascending-omega ordering (plus the last) pays a
    full factorization; in between, the compressed G sample stack is the
    omega-LERP of the two bracketing anchor stacks (G is as smooth in omega
    as it is in m: the factor_stride argument) and only H_F is re-factored.
    Requires g_compress=True and factor_stride > 1 (anchor stacks are kept
    as sample panels: two of them are ~2/stride of one dense stack) and a
    single const for the whole sweep (C shapes the subgrid PML, so mixed-C
    anchors would lerp different operators).  Records gain `setup_mode`
    ("factor" | "omega_lerp").

    Returns one record dict per frequency (per-source iteration counts,
    residuals, timings), in the order of `wave_nums`, with the reference
    package's keys; `compiled` is always False here (nothing is compiled
    per call).  `stencil="9pt"` runs the same sweep on the 9-point
    discretization (right-hand sides filtered by `fd.stencil.mass_filter9`,
    PML width checked as in `run_solver`).  `precond="recompute"` (5-point,
    no frequency amortization) keeps no factor stack; the batch shares each
    chunk's re-factorization (`precond.recompute.apply_recompute_multi`).

    `mesh_devices=D` runs the distributed path (`dist`): D ranks, one
    process each (`dist.launch.run_ranks`; in place when a process group
    of D ranks already runs), each holding a band of n / D grid rows and
    factoring only its band (`dist.factor.distributed_setup`); the solve is
    the distributed GMRES (`dist.solve`).  Needs D | n and b < n / D.  Its
    records (rank 0's) gain `mesh_devices`, `per_device_g_bytes` (one
    rank's G planes), `dist_backend`, `ranks_per_card` (None on the CPU),
    and per rank the kernel launches (`rank_launches`) and the peak device
    memory (`rank_peak_bytes`, None on the CPU) of that frequency.
    """
    dev = resolve_device(device)
    if mesh_devices and precond == "recompute":
        raise ValueError("precond='recompute' is the single-chip capacity "
                         "path; the distributed path shards stored factors")
    if stencil not in ("5pt", "9pt"):
        raise ValueError(f"unknown stencil {stencil!r}")
    nine = stencil == "9pt"
    if nine and precond != "moving_pml":
        raise ValueError(f"multisolve stencil='9pt' supports "
                         f"precond='moving_pml', got {precond!r} "
                         "(recompute is a 5-point-path feature)")
    if precond not in ("moving_pml", "recompute"):
        raise ValueError(f"unknown multisolve precond {precond!r}")
    if nine:
        _check_pml_width9(n, b)
    _set_full_float32()
    cdtype = complex_dtype or default_complex_dtype(dev)
    wf = {torch.float32: np.float32,
          torch.float64: np.float64}[real_dtype_of(cdtype)]
    if consts is None:
        consts = [100.0] * len(wave_nums)
    elif len(consts) == 1:
        consts = list(consts) * len(wave_nums)
    if len(consts) != len(wave_nums):
        raise ValueError(f"{len(consts)} consts for {len(wave_nums)} "
                         "frequencies (zip would silently drop the rest)")
    r1s = np.linspace(0.2, 0.8, n_sources).astype(wf)
    r2s = np.full((n_sources,), source_y, wf)
    if factor_stride is None:
        factor_stride = auto_factor_stride(n, problem, dev)
    key_cfg = multisolve_key_config(
        n, b, problem, rtol, n_sources, fidelity=fidelity, g_dtype=g_dtype,
        factor_stride=factor_stride, g_compress=g_compress,
        freq_anchor_every=freq_anchor_every, precond=precond,
        stencil=stencil, stencil_gamma=stencil_gamma,
        mesh_devices=mesh_devices, precision=precision,
        precond_refine=precond_refine)
    if freq_anchor_every > 1:
        if precond != "moving_pml":
            raise ValueError("freq_anchor_every amortizes STORED factor "
                             "samples (precond='moving_pml')")
        if not g_compress or factor_stride <= 1:
            raise ValueError(
                "freq_anchor_every > 1 requires g_compress=True and "
                "factor_stride > 1 (anchor stacks are kept as sample "
                "panels)")
        if len(set(map(float, consts))) != 1:
            raise ValueError(
                "freq_anchor_every > 1 requires a single const: C shapes "
                "the subgrid PML, so mixed-C anchor stacks would lerp "
                "different operators")
    if mesh_devices:
        from .dist.launch import run_ranks
        from .dist.partition import LayerMesh, check_band

        check_band(n, b, LayerMesh(int(mesh_devices), 0, dev))
        return run_ranks(
            _multisolve_on_ranks, int(mesh_devices), device=dev,
            job=dict(n=n, b=b, wave_nums=[float(w) for w in wave_nums],
                     consts=[float(C) for C in consts], alpha=alpha,
                     problem=problem, r1s=r1s, r2s=r2s, rtol=rtol,
                     restart=restart, maxiter=maxiter, fidelity=fidelity,
                     setup_chunk=setup_chunk, g_dtype=g_dtype,
                     factor_stride=factor_stride, g_compress=g_compress,
                     freq_anchor_every=freq_anchor_every, stencil=stencil,
                     stencil_gamma=stencil_gamma, precision=precision,
                     precond_refine=precond_refine, cdtype=cdtype,
                     key_cfg=key_cfg))
    common = dict(n=n, n_sources=n_sources, cdtype=cdtype, g_dtype=g_dtype)
    stage = dict(n=n, b=b, problem=problem, fidelity=fidelity, cdtype=cdtype,
                 device=dev)
    factor = dict(d2_replace=True, setup_chunk=setup_chunk, g_dtype=g_dtype,
                  factor_stride=factor_stride)
    solve = dict(restart=restart, maxiter=maxiter, precision=precision,
                 precond_refine=precond_refine, device=dev)

    def sources_at(wn, C):
        F = _sources_stage(wn, alpha, r1s, r2s, n=n, problem=problem,
                           cdtype=cdtype, device=dev)
        return _mass_filter9_stage(F, wn, C, alpha, n=n, b=b) if nine else F

    def factor_at(wn, C, compress):
        """(A, P) of one frequency, assembled and factored from scratch."""
        if nine:
            with phase("assemble"), phase("factor"):
                A, _, P = _setup9_stage(wn, C, alpha, stencil_gamma,
                                        g_compress=compress, **stage,
                                        **factor)
            return A, P
        if precond == "recompute":
            # factor-free: the batch shares each chunk's re-factorization
            with phase("assemble"):
                A, c_full, _ = _assemble_a_stage(wn, C, alpha, **stage)
            with phase("factor"):
                return A, _factor_recompute_stage(
                    A, c_full, wn, C, alpha, n=n, b=b, fidelity=fidelity,
                    hf_full_coupling=True, d2_replace=True,
                    factor_stride=factor_stride)
        with phase("assemble"):
            A, hm, _ = _assemble_stage(wn, C, alpha, **stage)
        with phase("factor"):
            return A, _factor_stage(A, hm, b=b, hf_full_coupling=True,
                                    g_compress=compress, device=dev,
                                    **factor)

    def assemble_at(wn, C):
        """The operator alone, for a frequency between two anchors."""
        if nine:
            return _assemble_a9_stage(wn, C, alpha, stencil_gamma, **stage)[0]
        return _assemble_a_stage(wn, C, alpha, **stage)[0]

    if freq_anchor_every > 1:
        def solve_and_record(wn, A, P, t0, t1):
            F = sources_at(wn, consts[0])
            with phase("solve"):
                res = _msolve_stage(A, P, F, rtol, **solve)
            _sync(dev)
            t2 = time.perf_counter()
            return _multisolve_record(
                key_cfg, A, P, res, F, wave_num=wn, const=consts[0], t0=t0,
                t1=t1, t2=t2, g_compress=True, **common)

        def lerp_at(wn, P_p, P_a, tau):
            A_i = assemble_at(wn, consts[0])
            return A_i, _precond_from_samples_stage(
                A_i, P_p, P_a, tau, b=b, g_stride=factor_stride)

        return _run_multisolve_amortized(
            [float(w) for w in wave_nums],
            lambda wn: factor_at(wn, consts[0], True), lerp_at,
            solve_and_record, freq_anchor_every=freq_anchor_every,
            sync=lambda: _sync(dev))

    records = []
    A = P = res = None
    for wn, C in zip(wave_nums, consts):
        # free the previous frequency's factor stack BEFORE building the
        # next one: two float32 stacks at n = 2047 do not fit the card
        A = P = res = None  # noqa: F841
        _sync(dev)
        t0 = time.perf_counter()
        F = sources_at(wn, C)
        A, P = factor_at(wn, C, g_compress)
        _sync(dev)
        t1 = time.perf_counter()
        with phase("solve"):
            res = _msolve_stage(A, P, F, rtol, **solve)
        _sync(dev)
        t2 = time.perf_counter()
        records.append(_multisolve_record(
            key_cfg, A, P, res, F, wave_num=wn, const=C, t0=t0, t1=t1,
            t2=t2, g_compress=g_compress, **common))
    return records


def _run_multisolve_amortized(wave_nums, factor_at, lerp_at,
                              solve_and_record, *, freq_anchor_every, sync):
    """Amortized multi-frequency sweep (`run_multisolve`
    freq_anchor_every): factor anchors, omega-lerp the compressed sample
    stacks in between.  `factor_at(wn)` gives an anchor's (A, P),
    `lerp_at(wn, P_p, P_a, tau)` an intermediate frequency's (A, P) from
    its bracketing anchors, and `solve_and_record(wn, A, P, t0, t1)` solves
    one frequency and returns its record; `sync()` waits for the device
    (and the ranks).  The single-card and the distributed sweeps pass their
    own.

    Frequencies are processed in ascending-omega order span by span; at
    most two anchor sample stacks (plus one lerped stack) are resident,
    ~3/stride of one dense G stack.  Records are returned in the caller's
    `wave_nums` order, each with `setup_mode`."""
    K = len(wave_nums)
    order = sorted(range(K), key=lambda i: wave_nums[i])
    anchor_pos = sorted({p for p in range(0, K, freq_anchor_every)}
                        | {K - 1})
    records: dict[int, dict] = {}

    def timed(idx, make, mode):
        sync()
        t0 = time.perf_counter()
        A, P = make()
        sync()
        t1 = time.perf_counter()
        records[idx] = {**solve_and_record(wave_nums[idx], A, P, t0, t1),
                        "setup_mode": mode}
        return P

    prev = None                       # (sorted position, wn, anchor P)
    for a in anchor_pos:
        idx_a = order[a]
        wn_a = wave_nums[idx_a]
        P_a = timed(idx_a, lambda: factor_at(wn_a), "factor")
        if prev is not None:
            pos_p, wn_p, P_p = prev
            for p in range(pos_p + 1, a):
                idx = order[p]
                wn_i = wave_nums[idx]
                tau = (wn_i - wn_p) / max(wn_a - wn_p, 1e-30)
                timed(idx, lambda: lerp_at(wn_i, P_p, P_a, tau),
                      "omega_lerp")
            del P_p                   # span done, drop the anchor
        prev = (a, wn_a, P_a)
    return [records[i] for i in range(K)]


def _launch_counts() -> dict:
    """This process's kernel launch counters and the distributed path's own
    counts, for differences around one frequency."""
    from .dist import spmv as dist_spmv
    from .dist import sweep as dist_sweep
    from .ops.kernels import gj_inverse, spmv_stencil, sweep

    return {"stencil_matvec": spmv_stencil.launches,
            "sweep": sweep.launches, "gj_inverse": gj_inverse.launches,
            "sweep_variants": dict(sweep.launches_by_variant),
            "band_products": dist_spmv.band_products,
            "apply_chunks": dist_sweep.apply_chunks}


def _counts_since(before: dict) -> dict:
    now = _launch_counts()
    out = {k: now[k] - before[k] for k in now if k != "sweep_variants"}
    out["sweep_variants"] = {
        ",".join(map(str, k)): c - before["sweep_variants"].get(k, 0)
        for k, c in now["sweep_variants"].items()
        if c != before["sweep_variants"].get(k, 0)}
    return out


@torch.no_grad()
def _multisolve_on_ranks(device, job: dict) -> list:
    """`run_multisolve(mesh_devices=D)` on one rank (`dist.launch`): the
    frequency loop over this rank's band, with records on every rank (rank
    0's are returned).  `job` holds run_multisolve's normalized arguments."""
    from .dist import comm
    from .dist.factor import (distributed_assemble, distributed_assemble9,
                              distributed_setup, distributed_setup9)
    from .dist.launch import local_ranks, ranks_per_card
    from .dist.partition import make_mesh
    from .dist.solve import band_true_residuals, distributed_solve

    j = job
    n, b, K = j["n"], j["b"], len(j["r1s"])
    nine = j["stencil"] == "9pt"
    mesh = make_mesh(j["key_cfg"]["mesh_devices"], device=device)
    dev = mesh.device
    n_loc, j0 = mesh.band(n)
    _set_full_float32()
    cd = j["cdtype"]
    common = dict(fidelity=j["fidelity"], complex_dtype=cd)
    setup = dict(g_dtype=j["g_dtype"], setup_chunk=j["setup_chunk"],
                 factor_stride=j["factor_stride"], **common)
    if nine:
        setup["gamma"] = common["gamma"] = j["stencil_gamma"]

    def sync():
        _sync(dev)
        comm.barrier(mesh)

    def sources_at(wn, C):
        F = _sources_stage(wn, j["alpha"], j["r1s"], j["r2s"], n=n,
                           problem=j["problem"], cdtype=cd, device=dev)
        if nine:
            F = _mass_filter9_stage(F, wn, C, j["alpha"], n=n, b=b)
        return F[:, j0:j0 + n_loc].contiguous()

    def factor_at(wn, C, compress):
        fn = distributed_setup9 if nine else distributed_setup
        with phase("assemble"), phase("factor"):
            A, S, _ = fn(mesh, n, b, wn, C, j["alpha"], j["problem"],
                         g_compress=compress, **setup)
        return A, S

    def lerp_at(wn, S_p, S_a, tau):
        if nine:
            A, S0, _ = distributed_assemble9(
                mesh, n, b, wn, j["consts"][0], j["alpha"], j["problem"],
                g_dtype=j["g_dtype"], **common)
        else:
            A, S0, _ = distributed_assemble(
                mesh, n, b, wn, j["consts"][0], j["alpha"], j["problem"],
                **common)
        G_re, G_im = _omega_lerp_pair(S_p.G_re, S_p.G_im, S_a.G_re,
                                      S_a.G_im, tau)
        return A, dataclasses.replace(S0, G_re=G_re, G_im=G_im, g_w=S_a.g_w,
                                      g_lo=S_a.g_lo, g_stride=S_a.g_stride)

    def solve_and_record(wn, C, A, S, t0, t1, before):
        F = sources_at(wn, C)
        with phase("solve"):
            res = distributed_solve(
                mesh, A, S, F, rtol=j["rtol"], restart=j["restart"],
                maxiter=j["maxiter"], precision=j["precision"],
                precond_refine=j["precond_refine"])
        sync()
        t2 = time.perf_counter()
        true_res = band_true_residuals(mesh, A, res.x.reshape(K, n_loc, n),
                                       F)
        peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
                else None)
        ranks = comm.all_gather_object(mesh, (_counts_since(before), peak))
        return {
            **j["key_cfg"], "wave_num": float(wn), "const": float(C),
            "iterations": np.asarray(res.iterations).tolist(),
            "converged": np.asarray(res.converged).tolist(),
            "true_residuals": true_res,
            "init_time_s": t1 - t0, "solve_time_s": t2 - t1,
            "compiled": False, "dtype": str(cd).replace("torch.", ""),
            "g_dtype": j["g_dtype"],
            "per_device_g_bytes": int(S.G_re.numel() * S.G_re.element_size()
                                      * 2),
            "dist_backend": mesh.backend or "none",
            "ranks_per_card": ranks_per_card(dev, local_ranks(mesh.size)),
            "rank_launches": [c for c, _ in ranks],
            "rank_peak_bytes": [p for _, p in ranks],
        }

    def begin():
        if dev.type == "cuda":
            torch.cuda.reset_peak_memory_stats(dev)
        return _launch_counts()

    if j["freq_anchor_every"] > 1:
        C = j["consts"][0]
        state = {}

        def factor_one(wn):
            state["before"] = begin()
            return factor_at(wn, C, True)

        def lerp_one(wn, S_p, S_a, tau):
            state["before"] = begin()
            return lerp_at(wn, S_p, S_a, tau)

        return _run_multisolve_amortized(
            j["wave_nums"], factor_one, lerp_one,
            lambda wn, A, S, t0, t1: solve_and_record(
                wn, C, A, S, t0, t1, state["before"]),
            freq_anchor_every=j["freq_anchor_every"], sync=sync)

    records = []
    for wn, C in zip(j["wave_nums"], j["consts"]):
        A = S = None  # noqa: F841
        before = begin()
        sync()
        t0 = time.perf_counter()
        A, S = factor_at(wn, C, j["g_compress"])
        sync()
        t1 = time.perf_counter()
        records.append(solve_and_record(wn, C, A, S, t0, t1, before))
    return records


@torch.no_grad()
def build_preconditioner(n: int, b: int, wave_num: float, const: float,
                         alpha: float = 2.0, problem: str = "c1_f1", *,
                         fidelity: str = "corrected",
                         hf_full_coupling: bool = True,
                         d2_replace: bool = True,
                         setup_chunk: int = DEFAULT_SETUP_CHUNK,
                         complex_dtype=None,
                         device="cuda"):
    """Assemble and factor only (stride 1, G at the working precision):
    returns (P, A, f_grid) on `device`, for checkpointing
    (`utils.checkpoint`) or reuse across many solves."""
    dev = resolve_device(device)
    _set_full_float32()
    cdtype = complex_dtype or default_complex_dtype(dev)
    A, hm, f_grid = _assemble_stage(
        wave_num, const, alpha, n=n, b=b, problem=problem, fidelity=fidelity,
        cdtype=cdtype, device=dev)
    P = _factor_stage(A, hm, b=b, hf_full_coupling=hf_full_coupling,
                      d2_replace=d2_replace, setup_chunk=setup_chunk,
                      device=dev)
    return P, A, f_grid
