"""The high-level entry points: `run_solver`, the end-to-end preconditioned
solve, and `run_multisolve`, many sources and many frequencies against one
operator each.

Eager stages (assemble, factor, solve) on one device.  On the card every
operator product goes through the stencil kernel and every sweep through the
sweep kernel (`ops.kernels`); on the CPU, which the caller must ask for, the
same wrappers run their plain PyTorch versions.
"""
from __future__ import annotations

import dataclasses
import math
import time
from typing import Optional

import numpy as np
import torch

from ._device import real_dtype_of, resolve_device
from .core.sparse import Stencil5
from .fd import problems as fd_problems
from .fd import stencil as fd_stencil
from .ops import spmv as plain_spmv
from .ops.kernels.spmv_stencil import stencil_matvec_flat
from .precond.sweeping import (DEFAULT_SETUP_CHUNK, SweepingPreconditioner,
                               preconditioner_from_samples,
                               setup_preconditioner)
from .solve.batched import solve_multi_rhs
from .solve.gmres import KrylovResult, gmres
from .solve.ir import ir_gmres, ir_gmres_batched


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
                 inner_rtol=1e-2, device) -> KrylovResult:
    if precision not in ("f32", "ir-df32"):
        raise ValueError(f"unknown precision {precision!r}")
    if method == "bicgstab":
        raise NotImplementedError(
            "method='bicgstab' belongs to the solver-extras slice of the "
            "port, which is not ported yet")
    if method != "gmres":
        raise ValueError(f"unknown method {method!r}")

    mv = lambda v: stencil_matvec_flat(A, v)
    M = _refined(P, mv, precond_refine) if use_precond else None
    if precision == "ir-df32":
        # complex128 solution carry + complex128 residual: the path that
        # actually reaches rtol 1e-6 with a complex64 operator and M
        return ir_gmres(mv, _matvec_hi(A), f.reshape(-1), M=M, rtol=rtol,
                        restart=restart, maxiter=maxiter,
                        inner_rtol=inner_rtol, device=device)
    return gmres(mv, f.reshape(-1), M=M, restart=restart, rtol=rtol,
                 maxiter=maxiter, device=device)


def _matvec_hi(A: Stencil5):
    """The operator product in complex128 on A's own coefficients, widened:
    (..., N) -> (..., N), plain PyTorch.  What the refinement's residual
    b - A x is computed with."""
    A_hi = A.map(lambda f: f.to(torch.complex128))
    return lambda x: plain_spmv.stencil_matvec_flat(A_hi, x)


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
    _set_full_float32()
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


def _msolve_stage(A: Stencil5, P: SweepingPreconditioner, F: torch.Tensor,
                  rtol, *, restart, maxiter, method="gmres",
                  precision="f32", precond_refine=0, inner_rtol=1e-2,
                  device) -> KrylovResult:
    """Batched-RHS solve: (K, n, n) right-hand sides through one operator
    and one preconditioner, the batch sharing a single G stream per apply.
    The operator product runs once per right-hand side (the stencil kernel
    takes one grid).  `precision="ir-df32"` and `precond_refine` mirror the
    single-RHS `_solve_stage`."""
    K = F.shape[0]
    mv = lambda V: torch.stack([stencil_matvec_flat(A, v) for v in V])
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


def _g_accounting(P: SweepingPreconditioner, n, b, g_compress) -> dict:
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


def _precond_from_samples_stage(A: Stencil5, P_a: SweepingPreconditioner,
                                P_b: SweepingPreconditioner, tau: float, *,
                                b, g_stride, hf_full_coupling=True,
                                d2_replace=True) -> SweepingPreconditioner:
    """Preconditioner at an intermediate frequency of an amortized sweep:
    the compressed G sample stack is the omega-LERP of the two bracketing
    anchor stacks (float32 accumulation; same smoothness argument as
    factor_stride: G is as smooth in omega as it is in m), and only H_F is
    actually factored.  Setup cost: one streaming pass over the two anchor
    stacks instead of ~M/stride dense corner factorizations."""
    G_re, G_im = _omega_lerp_pair(P_a.G_re, P_a.G_im, P_b.G_re, P_b.G_im,
                                  tau)
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
        (_host_stencil_matvec(A_np, X[k]) - F_np[k]).ravel())
        / np.linalg.norm(F_np[k].ravel())) for k in range(n_sources)]
    return {
        **key_cfg, "wave_num": float(wave_num), "const": float(const),
        "iterations": np.asarray(res.iterations).tolist(),
        "converged": np.asarray(res.converged).tolist(),
        "true_residuals": true_res,
        "init_time_s": t1 - t0, "solve_time_s": t2 - t1,
        "compiled": False,
        "dtype": str(cdtype).replace("torch.", ""),
        **_g_accounting(P, n, P.b, g_compress), "g_dtype": g_dtype,
    }


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
    per call).  `mesh_devices`, `stencil="9pt"` and `precond="recompute"`
    belong to later slices of the port and raise NotImplementedError.
    """
    dev = resolve_device(device)
    if mesh_devices:
        raise NotImplementedError(
            "mesh_devices belongs to the distributed slice of the port "
            "(queue 1 item 16), which is not ported yet")
    if stencil == "9pt":
        raise NotImplementedError(
            "stencil='9pt' belongs to the 9-point slice of the port (queue "
            "1 item 12): only the 5-point scheme is ported yet")
    if stencil != "5pt":
        raise ValueError(f"unknown stencil {stencil!r}")
    if precond == "recompute":
        raise NotImplementedError(
            "precond='recompute' belongs to the recompute slice of the port "
            "(queue 1 item 15), which is not ported yet")
    if precond != "moving_pml":
        raise ValueError(f"unknown multisolve precond {precond!r}")
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
    common = dict(n=n, n_sources=n_sources, cdtype=cdtype, g_dtype=g_dtype)
    stage = dict(n=n, b=b, problem=problem, fidelity=fidelity, cdtype=cdtype,
                 device=dev)
    factor = dict(b=b, hf_full_coupling=True, d2_replace=True,
                  setup_chunk=setup_chunk, g_dtype=g_dtype,
                  factor_stride=factor_stride, device=dev)
    solve = dict(restart=restart, maxiter=maxiter, precision=precision,
                 precond_refine=precond_refine, device=dev)

    def sources_at(wn):
        return _sources_stage(wn, alpha, r1s, r2s, n=n, problem=problem,
                              cdtype=cdtype, device=dev)

    if freq_anchor_every > 1:
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
        return _run_multisolve_amortized(
            [float(w) for w in wave_nums], float(consts[0]), alpha,
            sources_at, rtol=rtol, factor_stride=factor_stride,
            freq_anchor_every=freq_anchor_every, key_cfg=key_cfg,
            common=common, stage=stage, factor=factor, solve=solve)

    records = []
    A = P = res = None
    for wn, C in zip(wave_nums, consts):
        # free the previous frequency's factor stack BEFORE building the
        # next one: two float32 stacks at n = 2047 do not fit the card
        A = P = res = None  # noqa: F841
        _sync(dev)
        t0 = time.perf_counter()
        F = sources_at(wn)
        A, hm, _ = _assemble_stage(wn, C, alpha, **stage)
        P = _factor_stage(A, hm, g_compress=g_compress, **factor)
        del hm
        _sync(dev)
        t1 = time.perf_counter()
        res = _msolve_stage(A, P, F, rtol, **solve)
        _sync(dev)
        t2 = time.perf_counter()
        records.append(_multisolve_record(
            key_cfg, A, P, res, F, wave_num=wn, const=C, t0=t0, t1=t1,
            t2=t2, g_compress=g_compress, **common))
    return records


def _run_multisolve_amortized(wave_nums, const, alpha, sources_at, *, rtol,
                              factor_stride, freq_anchor_every, key_cfg,
                              common, stage, factor, solve):
    """Amortized multi-frequency sweep (`run_multisolve`
    freq_anchor_every): factor anchors, omega-lerp the compressed sample
    stacks in between.

    Frequencies are processed in ascending-omega order span by span; at
    most two anchor sample stacks (plus one lerped stack) are resident,
    ~3/stride of one dense G stack.  Records are returned in the caller's
    `wave_nums` order."""
    dev = stage["device"]
    K = len(wave_nums)
    order = sorted(range(K), key=lambda i: wave_nums[i])
    anchor_pos = sorted({p for p in range(0, K, freq_anchor_every)}
                        | {K - 1})
    records: dict[int, dict] = {}

    def solve_and_record(idx, A, P, t0, t1, mode):
        wn = wave_nums[idx]
        F = sources_at(wn)
        res = _msolve_stage(A, P, F, rtol, **solve)
        _sync(dev)
        t2 = time.perf_counter()
        records[idx] = {**_multisolve_record(
            key_cfg, A, P, res, F, wave_num=wn, const=const, t0=t0, t1=t1,
            t2=t2, g_compress=True, **common), "setup_mode": mode}

    prev = None                       # (sorted position, wn, anchor P)
    for a in anchor_pos:
        idx_a = order[a]
        wn_a = wave_nums[idx_a]
        _sync(dev)
        t0 = time.perf_counter()
        A_a, hm, _ = _assemble_stage(wn_a, const, alpha, **stage)
        P_a = _factor_stage(A_a, hm, g_compress=True, **factor)
        del hm
        _sync(dev)
        t1 = time.perf_counter()
        solve_and_record(idx_a, A_a, P_a, t0, t1, "factor")
        del A_a                       # free before the span
        if prev is not None:
            pos_p, wn_p, P_p = prev
            for p in range(pos_p + 1, a):
                idx = order[p]
                wn_i = wave_nums[idx]
                tau = (wn_i - wn_p) / max(wn_a - wn_p, 1e-30)
                _sync(dev)
                t0 = time.perf_counter()
                A_i, _, _ = _assemble_a_stage(wn_i, const, alpha, **stage)
                P_i = _precond_from_samples_stage(
                    A_i, P_p, P_a, tau, b=stage["b"], g_stride=factor_stride)
                _sync(dev)
                t1 = time.perf_counter()
                solve_and_record(idx, A_i, P_i, t0, t1, "omega_lerp")
                del A_i, P_i
            del P_p                   # span done, drop the anchor
        prev = (a, wn_a, P_a)
    return [records[i] for i in range(K)]
