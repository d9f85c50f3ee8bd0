"""Preconditioned BiCGStab (van der Vorst variant) as an eager loop.

Same semantics as the JAX package's `solve/bicgstab.py`: convergence
follows scipy's bicgstab, on the UNPRECONDITIONED residual
||b - A x|| <= max(rtol ||b||, atol), decided at the end on the recomputed
true residual; each iteration performs two operator products and two
preconditioner applications; the initial residual is b - A x0 (one product,
also for the zero x0); breakdown guards clamp rho, the denominator and
t.t at tiny * 1e3.

`bicgstab_batched` steps a batch of right-hand sides in LOCKSTEP: one
batched operator product and one batched preconditioner apply per half-step
for the members still iterating, each member with its own scalars,
breakdown flag and iteration count; a finished member freezes.  That is
what the JAX package's `vmap` over `bicgstab` computes.  The scalars stay
on the device; one host read per step decides who goes on.  `bicgstab` is
that loop on a batch of one.
"""
from __future__ import annotations

from typing import Callable, Optional

import numpy as np
import torch

from .._device import resolve_device
from .gmres import KrylovResult, first_member, on_batch_of_one


def _dot(a: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """Row-wise complex inner products conj(a) . c of (k, N) batches."""
    return torch.sum(a.conj() * c, dim=-1)


def _norm(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(v.real ** 2 + v.imag ** 2, dim=-1))


@torch.no_grad()
def bicgstab_batched(matvec: Callable, B: torch.Tensor, *,
                     M: Optional[Callable] = None,
                     x0: Optional[torch.Tensor] = None,
                     rtol: float = 1e-3,
                     atol: float = 0.0,
                     maxiter: int = 1000,
                     device="cuda") -> KrylovResult:
    """BiCGStab on a batch B (K, N) in lockstep.  `matvec` and `M` map a
    (k, N) batch to a (k, N) batch, row by row the same operator; they are
    called on the k <= K members still iterating.  The result holds x
    (K, N), numpy arrays (K,) for the scalars and (K, maxiter) for the
    nan-padded history of unpreconditioned residual norms."""
    dev = resolve_device(device)
    if B.device.type != dev.type:
        raise ValueError(f"B is on {B.device} but device={device!r}")
    if M is None:
        M = lambda V: V
    K, _ = B.shape
    rdtype = B.real.dtype
    eps = torch.finfo(rdtype).tiny * 1e3
    one = torch.ones((), dtype=B.dtype, device=B.device)

    bnorm = _norm(B)
    tol = torch.clamp(rtol * bnorm, min=atol)
    X = torch.zeros_like(B) if x0 is None else x0.clone()
    R = B - matvec(X)
    Rhat = R.clone()
    P = torch.zeros_like(B)
    V = torch.zeros_like(B)
    rho = one.expand(K).clone()
    alpha = rho.clone()
    omega = rho.clone()
    resnorm = _norm(R)
    brk = bnorm == 0.0

    history = np.full((K, maxiter), np.nan,
                      np.float64 if rdtype == torch.float64 else np.float32)
    iters = np.zeros((K,), np.int64)
    res_h, tol_h, brk_h = (t.cpu().numpy().copy()
                           for t in (resnorm, tol, brk))
    while True:
        act = [i for i in range(K) if res_h[i] > tol_h[i]
               and iters[i] < maxiter and not brk_h[i]]
        if not act:
            break
        idx = torch.as_tensor(act, device=B.device)
        r, rh = R[idx], Rhat[idx]
        rho_new = _dot(rh, r)
        breakdown = rho_new.abs() < eps
        om_old = omega[idx]
        beta = (rho_new / torch.where(breakdown, one, rho[idx])) \
            * (alpha[idx] / torch.where(om_old == 0, one, om_old))
        p = r + beta[:, None] * (P[idx] - om_old[:, None] * V[idx])
        phat = M(p)
        v = matvec(phat)
        denom = _dot(rh, v)
        breakdown |= denom.abs() < eps
        a = rho_new / torch.where(breakdown, one, denom)
        s = r - a[:, None] * v
        shat = M(s)
        t = matvec(shat)
        tt = _dot(t, t)
        om = _dot(t, s) / torch.where(tt.abs() < eps, one, tt)
        X[idx] = X[idx] + a[:, None] * phat + om[:, None] * shat
        r = s - om[:, None] * t
        rn = _norm(r)
        R[idx], P[idx], V[idx] = r, p, v
        rho[idx], alpha[idx], omega[idx] = rho_new, a, om
        resnorm[idx] = rn
        brk[idx] = brk[idx] | breakdown
        # one host read per step: the members' residual norms and flags
        host = torch.stack([rn, breakdown.to(rdtype)]).cpu().numpy()
        rn_h, bd_h = host[0], host[1] > 0
        for q, i in enumerate(act):
            history[i, iters[i]] = rn_h[q]
            iters[i] += 1
            res_h[i] = rn_h[q]
            brk_h[i] = brk_h[i] or bool(bd_h[q])

    final = _norm(B - matvec(X))
    final_h = final.cpu().numpy()
    return KrylovResult(x=X, iterations=iters,
                        converged=final_h <= tol_h, breakdown=brk_h,
                        residual_norm=final_h.astype(np.float64),
                        history=history)


def bicgstab(matvec: Callable, b: torch.Tensor, *,
             M: Optional[Callable] = None,
             x0: Optional[torch.Tensor] = None, **kw) -> KrylovResult:
    """`bicgstab_batched` for one right-hand side: `matvec` and `M` map flat
    (N,) vectors, `b` and `x0` are (N,), and the result's fields are
    scalars."""
    return first_member(bicgstab_batched(
        on_batch_of_one(matvec), b[None], M=on_batch_of_one(M),
        x0=None if x0 is None else x0[None], **kw))
