"""Mixed-precision iterative refinement around the complex64 GMRES core.

The precision option for tight tolerances: plain complex64 GMRES stalls at
a true relative residual of a few 1e-6 at n = 1023, because both the
solution accumulator and the recomputed residual b - A x are floored at
float32 working precision.  Classic mixed-precision iterative refinement
fixes both:

    x carried in complex128 on the device;
    r_k = b - A x computed in complex128 (`matvec_hi`: the plain stencil
          product on the operator's coefficients widened to complex128);
    inner: complex64 preconditioned GMRES solves A d = r_k to a loose rtol;
    x <- x + d in complex128.

The reference package has no float64 on its device and carries x as a pair
of float32 values with compensated arithmetic instead; the card has FP64, so
the port uses it.  The option keeps the reference's name,
`precision="ir-df32"`.

Because the inner solve uses the same left preconditioner M and its RHS is
the current global residual, the inner per-iteration preconditioned
residuals ARE the global ones (M r_new = M r_k - M A d), so the concatenated
history and the total inner-iteration count are directly comparable with a
single uninterrupted GMRES: the parity metric.

Convergence keeps the legacy-scipy semantics: ||M r_k|| <= rtol * ||M b||,
with r_k the complex128 residual, so the test is trustworthy below the
float32 floor.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .gmres import (KrylovResult, _norms, first_member, gmres_batched,
                    on_batch_of_one)


@torch.no_grad()
def ir_gmres_batched(matvec: Callable, matvec_hi: Callable, B: torch.Tensor,
                     *, M: Optional[Callable] = None,
                     rtol: float = 1e-6,
                     atol: float = 0.0,
                     restart: int = 20,
                     maxiter: int = 200,
                     inner_rtol: float = 1e-2,
                     max_outer: int = 12,
                     device="cuda") -> KrylovResult:
    """Solve A X = B (K, N) to rtol (legacy preconditioned semantics) with
    working-precision inner solves, the members in lockstep.

    matvec     : working-precision operator on (k, N) batches.
    matvec_hi  : the same operator on complex128 (k, N) batches.
    M          : left preconditioner on (k, N) batches (None = identity).
    inner_rtol : per-cycle residual reduction requested from the inner
                 GMRES (each cycle re-scales, so the overall floor is set by
                 the complex128 residual).

    Per member: `iterations` counts all inner iterations, `history` is the
    concatenated per-inner-iteration preconditioned residual history
    (nan-padded), `x` the complex128 solution rounded to the working type.
    A member stops when it converged, when a cycle did not reduce its
    residual (`breakdown`), after `max_outer` cycles or `maxiter`
    iterations; the others go on without it.
    """
    if M is None:
        M = lambda V: V
    K, N = B.shape
    dtype = B.dtype
    hi = torch.complex128
    np_r = np.finfo(np.dtype({torch.complex64: np.complex64,
                              torch.complex128: np.complex128}[dtype])).dtype
    rt = np_r.type

    bnorm = _norms(M(B), np_r)
    tol = np.maximum(rt(rtol) * bnorm, rt(atol))
    # per-cycle inner budget: full maxiter (the outer loop stops on iters)
    inner_hist = -(-maxiter // restart) * restart
    history = np.full((K, inner_hist * max_outer), np.nan, np_r)

    B_hi = B.to(hi)
    X = torch.zeros_like(B_hi)
    R = B.clone()
    outer = np.zeros((K,), np.int64)
    iters = np.zeros((K,), np.int64)
    res = bnorm.copy()
    done = bnorm <= tol
    stalled = np.zeros((K,), bool)
    while True:
        act = [i for i in range(K) if not done[i] and not stalled[i]
               and outer[i] < max_outer and iters[i] < maxiter]
        if not act:
            break
        # iter_cap: the inner cycle spends only the REMAINING global budget,
        # so total reported iterations never exceed maxiter
        inner = gmres_batched(matvec, R[act], M=M, restart=restart,
                              rtol=inner_rtol, atol=0.0, maxiter=maxiter,
                              iter_cap=maxiter - iters[act], device=device)
        X[act] += inner.x.to(hi)
        for p, i in enumerate(act):
            history[i, iters[i]:iters[i] + inner_hist] = inner.history[p]
            iters[i] += inner.iterations[p]
        # trustworthy below the float32 floor
        R_act = (B_hi[act] - matvec_hi(X[act])).to(dtype)
        R[act] = R_act
        res_new = _norms(M(R_act), np_r)
        for p, i in enumerate(act):
            done[i] = res_new[p] <= tol[i]
            stalled[i] = (not done[i]) and bool(
                res_new[p] >= res[i] or not np.isfinite(res_new[p]))
            res[i] = res_new[p]
            outer[i] += 1

    return KrylovResult(x=X.to(dtype), iterations=iters,
                        converged=res <= tol, breakdown=stalled,
                        residual_norm=res.astype(np.float64),
                        history=history)


def ir_gmres(matvec: Callable, matvec_hi: Callable, b: torch.Tensor, *,
             M: Optional[Callable] = None, **kw) -> KrylovResult:
    """`ir_gmres_batched` for one right-hand side: `matvec`, `matvec_hi` and
    `M` map flat (N,) vectors, and the result's fields are scalars."""
    return first_member(ir_gmres_batched(
        on_batch_of_one(matvec), on_batch_of_one(matvec_hi), b[None],
        M=on_batch_of_one(M), **kw))
