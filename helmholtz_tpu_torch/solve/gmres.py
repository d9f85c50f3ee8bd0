"""Restarted GMRES(m) as an eager loop: the port's Krylov solver.

Same semantics as the JAX package's `solve/gmres.py` (and legacy scipy
`tol`): left preconditioning, convergence on ||M r|| <= rtol * ||M b||,
restart default 20, zero initial guess.  The Krylov vectors and every
product against them stay on the device; the small Hessenberg least-squares
problem is solved incrementally with complex Givens rotations on the host,
in the working precision, so the preconditioned residual norm is known every
inner iteration.  That costs one host read per inner step, which is nothing
at the handful of iterations the sweeping preconditioner needs.

The distributed variant (all-reduced inner products) is not ported yet.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class KrylovResult:
    """Solve outcome + observability artifacts."""

    x: torch.Tensor
    iterations: int              # total inner iterations performed
    converged: bool
    breakdown: bool              # happy breakdown / stagnation guard
    residual_norm: float         # final preconditioned ||M(b - A x)||
    history: np.ndarray          # per-iteration preconditioned residuals
                                 # (nan-padded to ceil(maxiter/restart)*restart)


def _givens(a, b):
    """Complex Givens rotation zeroing b against a (numpy scalars).

    Returns (c, s, r) with c real, s complex such that
      [c, s; -conj(s), c] @ [a; b] = [r; 0].
    """
    rdtype = np.abs(a).dtype
    eps = np.finfo(rdtype).tiny
    absa = np.abs(a)
    denom = np.sqrt(absa ** 2 + np.abs(b) ** 2)
    phase = a / absa if absa > eps else a.dtype.type(1.0)
    if denom > eps:
        c = absa / denom
        s = phase * np.conj(b) / denom
    else:
        c = rdtype.type(1.0)
        s = 0.0 * b
    r = phase * denom
    return c, s, r


def _norm(v: torch.Tensor) -> float:
    return float(torch.sqrt(torch.sum(v.real ** 2 + v.imag ** 2)))


@torch.no_grad()
def gmres(matvec: Callable, b: torch.Tensor, *,
          M: Optional[Callable] = None,
          x0: Optional[torch.Tensor] = None,
          restart: int = 20,
          rtol: float = 1e-3,
          atol: float = 0.0,
          maxiter: int = 1000,
          iter_cap: Optional[int] = None,
          device="cuda") -> KrylovResult:
    """Left-preconditioned restarted GMRES.  `matvec`/`M` map (N,) -> (N,)
    complex tensors on `device`, where `b` must already lie.

    `iter_cap` caps total inner iterations below `maxiter` (the handle for
    callers with a shared budget); the inner loop respects it too, so the
    count never exceeds the cap.
    """
    dev = resolve_device(device)
    if b.device.type != dev.type:
        raise ValueError(f"b is on {b.device} but device={device!r}")
    if M is None:
        M = lambda v: v
    N = b.shape[0]
    dtype = b.dtype
    np_c = np.dtype({torch.complex64: np.complex64,
                     torch.complex128: np.complex128}[dtype])
    np_r = np.finfo(np_c).dtype
    rt = np_r.type

    Mb = M(b)
    bnorm = rt(_norm(Mb))
    tol = rt(max(rt(rtol) * bnorm, rt(atol)))
    n_outer = -(-maxiter // restart)
    history = np.full((n_outer * restart,), np.nan, np_r)
    cap = maxiter if iter_cap is None else min(maxiter, int(iter_cap))
    happy_tol = np.finfo(np_r).eps * 100 * bnorm

    # x0 = 0 makes the initial residual Mb, already in hand for the
    # tolerance; a caller-supplied x0 pays one extra matvec + apply.
    if x0 is None:
        x = torch.zeros_like(b)
        r, beta = Mb, bnorm
    else:
        x = x0.clone()
        r = M(b - matvec(x))
        beta = rt(_norm(r))

    iters = 0
    done = bool(beta <= tol)
    stalled = False
    while not done and iters < cap:
        # r / beta are the preconditioned residual of x, carried in from
        # the previous cycle's convergence check (or the init): recomputing
        # them here would cost an extra matvec + preconditioner application
        # per restart cycle, and the apply is this workload's dominant part.
        j_limit = min(restart, cap - iters)
        V = torch.zeros((restart + 1, N), dtype=dtype, device=b.device)
        V[0] = r / (beta if beta > 0 else rt(1.0))
        H = np.zeros((restart + 1, restart), np_c)
        cs = np.zeros((restart,), np_r)
        sn = np.zeros((restart,), np_c)
        g = np.zeros((restart + 1,), np_c)
        g[0] = beta

        j = 0
        res = beta
        brk = bool(beta == 0.0)
        while j < j_limit and res > tol and not brk:
            # Arnoldi: classical Gram-Schmidt against the whole basis, plus
            # one re-orthogonalization pass for fp32 robustness.
            Vj = V[:j + 1]
            w = M(matvec(V[j]))
            h = Vj.conj() @ w
            w = w - h @ Vj
            h2 = Vj.conj() @ w
            w = w - h2 @ Vj
            h = h + h2
            hnorm = rt(_norm(w))
            happy = bool(hnorm <= happy_tol)
            if not happy:
                V[j + 1] = w / hnorm
            hcol = np.zeros((restart + 1,), np_c)
            hcol[:j + 1] = h.cpu().numpy()
            hcol[j + 1] = hnorm

            # apply the accumulated rotations to the new column
            for i in range(j):
                hi, hi1 = hcol[i], hcol[i + 1]
                hcol[i] = cs[i] * hi + sn[i] * hi1
                hcol[i + 1] = -np.conj(sn[i]) * hi + cs[i] * hi1
            c_new, s_new, r_new = _givens(hcol[j], hcol[j + 1])
            hcol[j] = r_new
            hcol[j + 1] = 0.0
            cs[j] = c_new
            sn[j] = s_new
            gj = g[j]
            g[j] = c_new * gj
            g[j + 1] = -np.conj(s_new) * gj
            H[:, j] = hcol
            res = np.abs(g[j + 1])
            # happy breakdown: the Krylov space is exact; residual is
            # |g[j+1]|
            brk = brk or happy
            j += 1
        k = j

        # per-iteration residual history from the Givens recurrence
        history[iters:iters + k] = np.abs(g[1:k + 1])

        # back-substitution on the k x k leading system
        y = np.zeros((k,), np_c)
        for i in range(k - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:k] @ y[i + 1:]) / H[i, i]
        if k:
            x = x + torch.from_numpy(y).to(b.device) @ V[:k]

        # Convergence is decided on a *recomputed* preconditioned residual,
        # not the Givens estimate: in fp32 the Arnoldi recurrence drifts and
        # the estimate can undershoot by orders of magnitude.  The
        # recomputed residual vector is carried into the next cycle, so the
        # trustworthy stopping test costs nothing extra.
        r = M(b - matvec(x))
        res_true = rt(_norm(r))
        done = bool(res_true <= tol)
        # stagnation guards: a breakdown cycle that did not converge, a
        # cycle with no residual reduction at all, or a cycle that performed
        # zero inner iterations will not improve on repeat.
        stalled = (not done) and bool(brk or res_true >= beta or k == 0
                                      or not np.isfinite(res_true))
        beta = res_true
        iters += k
        done = done or stalled

    return KrylovResult(x=x, iterations=int(iters),
                        converged=bool(beta <= tol),
                        breakdown=bool(stalled),
                        residual_norm=float(beta),
                        history=history)
