"""The unit of work the window drives: one gather at a frequency.

A user of a frequency-domain solver keeps one medium, and at each frequency
factors one operator and solves it for many sources.  `gather` does that
through the port's public stage functions, in the order the port's own
`run_multisolve` calls them, and hands the solutions back on the device:

1. `fd.problems.PROBLEMS[problem]` gives the medium;
2. `fd.stencil.build_a_stencil` builds the operator A;
3. `fd.stencil.build_hm_stencils` builds the moving-PML subgrids (one row of
   them, `build_hm_stencils_rows`, for a medium in
   `fd.problems.ROW_INVARIANT_VELOCITY`, as `run_solver`'s `dedup_hm` does);
4. `fd.problems.init_f1_mat` makes one right-hand side per source;
5. `precond.sweeping.setup_preconditioner` factors;
6. `solve.batched.solve_multi_rhs` solves the batch with GMRES, its
   operator product the stencil kernel's wrapper, one grid at a time, as
   the driver builds it.

With `spans` given (a `spans.Spans`), each stage, each operator product and
each preconditioner apply is a span that ends in a synchronize, and the
width of every apply is recorded for the sweep kernel's work count.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math

import numpy as np
import torch

from helmholtz_tpu_torch.fd import problems as fd_problems
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops.kernels.spmv_stencil import stencil_matvec_flat
from helmholtz_tpu_torch.precond.sweeping import setup_preconditioner
from helmholtz_tpu_torch.solve.batched import solve_multi_rhs

G_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16}
COMPLEX_DTYPES = {"complex64": torch.complex64}


@dataclasses.dataclass
class Gather:
    """What one request produced: the solutions (K, n*n) on the device,
    each source's GMRES iteration count and convergence flag."""
    x: torch.Tensor
    iterations: np.ndarray
    converged: np.ndarray


@dataclasses.dataclass(frozen=True)
class ApplyShape:
    """The shape of one preconditioner apply, for the sweep kernel's work
    count: grid size n, sweep rows, right-hand sides, and the G stack's
    layout (panels held, bytes an element, compressed, shared)."""
    n: int
    rows: int
    width: int
    planes: int
    g_itemsize: int
    lerp: bool
    shared: bool


def _no_span(_name):
    return contextlib.nullcontext()


def gather(cfg: dict, wave_num: float, xs, ys, *, rtol: float, restart: int,
           maxiter: int, device, spans=None, applies=None) -> Gather:
    """Assemble, factor and solve one frequency for the sources at
    (xs[k], ys[k]).  `applies`, a list, receives an `ApplyShape` per
    preconditioner apply."""
    span = spans.span if spans is not None else _no_span
    n, b = int(cfg["n"]), int(cfg["b"])
    const, problem = float(cfg["const"]), cfg["problem"]
    fidelity = cfg["fidelity"]
    cd = COMPLEX_DTYPES[cfg["complex_dtype"]]
    omega = complex(2.0 * math.pi * wave_num, float(cfg["alpha"]))
    h = 1.0 / (n + 1)
    eta = b * h
    rows_shared = (problem in fd_problems.ROW_INVARIANT_VELOCITY
                   and fidelity == "corrected")
    with span("assemble"):
        c_full, _ = fd_problems.PROBLEMS[problem](
            omega, n, complex_dtype=cd, device=device)
        A = fd_stencil.build_a_stencil(n, b, const, eta, omega, h, c_full,
                                       fidelity=fidelity, complex_dtype=cd)
        if rows_shared:
            hm = fd_stencil.build_hm_stencils_rows(
                torch.arange(b, b + 1, device=device), n, b, const, eta,
                omega, h, c_full, fidelity=fidelity, complex_dtype=cd)
        else:
            hm = fd_stencil.build_hm_stencils(n, b, const, eta, omega, h,
                                              c_full, fidelity=fidelity,
                                              complex_dtype=cd)
        F = torch.stack([fd_problems.init_f1_mat(
            float(x), float(y), omega, n, complex_dtype=cd, device=device)
            for x, y in zip(xs, ys)]).reshape(len(xs), n * n)
        del c_full
    with span("factor"):
        P = setup_preconditioner(
            A, hm, b, g_dtype=G_DTYPES[cfg["g_dtype"]],
            factor_stride=1 if rows_shared else int(cfg["factor_stride"]),
            g_compress=bool(cfg["g_compress"]), device=device)
        del hm

    def matvec(V):
        with span("matvec"):
            return torch.stack([stencil_matvec_flat(A, v) for v in V])

    shape = dict(n=n, rows=n - b, planes=int(P.G_re.shape[0]),
                 g_itemsize=P.G_re.element_size(), lerp=P.g_stride > 0,
                 shared=P.G_re.shape[0] == 1)

    def precond(V):
        if applies is not None:
            applies.append(ApplyShape(width=int(V.shape[0]), **shape))
        with span("apply"):
            return P.apply_multi(V)

    with span("solve"):
        res = solve_multi_rhs(matvec, F, M=precond, restart=restart,
                              rtol=rtol, maxiter=maxiter, device=device)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize(device)
    return Gather(x=res.x, iterations=np.asarray(res.iterations),
                  converged=np.asarray(res.converged))
