"""Restarted GMRES(m) as an eager loop: the port's Krylov solver.

Same semantics as the JAX package's `solve/gmres.py` (and legacy scipy
`tol`): left preconditioning, convergence on ||M r|| <= rtol * ||M b||,
restart default 20, zero initial guess.  The Krylov vectors and every
product against them stay on the device; the small Hessenberg least-squares
problem is solved incrementally with complex Givens rotations on the host,
in the working precision, so the preconditioned residual norm is known every
inner iteration.  That costs one host read per inner step, which is nothing
at the handful of iterations the sweeping preconditioner needs.

There is ONE loop, `gmres_batched`: a batch of right-hand sides stepped in
LOCKSTEP, one batched operator product and one batched preconditioner apply
per step for every member still iterating, while each member keeps its own
loop state: its own iteration count at which it leaves the inner loop, its
own least-squares problem and back-substitution, its own recomputed residual
and stagnation guard.  A member's iterations, flags, history and x do not
depend on who else is in the batch (up to the rounding of the batched
products).  `gmres` is that loop on a batch of one.

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
    """Solve outcome + observability artifacts.  A batched solve holds the same fields with a leading batch axis: x
    (B, N), numpy arrays (B,) for the scalars and (B, H) for the history."""

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


def _norms(V: torch.Tensor, np_r) -> np.ndarray:
    """Row norms of a (k, N) complex batch, on the host (one read)."""
    return torch.sqrt(torch.sum(V.real ** 2 + V.imag ** 2, dim=-1)) \
        .cpu().numpy().astype(np_r, copy=False)


def arnoldi_step(Vj: torch.Tensor, w: torch.Tensor):
    """Orthogonalize w against the basis rows Vj (j+1, N): classical
    Gram-Schmidt against the whole basis, plus one re-orthogonalization pass
    for fp32 robustness.  Returns (w, h) with h the (j+1,) coefficients."""
    h = Vj.conj() @ w
    w = w - h @ Vj
    h2 = Vj.conj() @ w
    w = w - h2 @ Vj
    return w, h + h2


class CycleLSQ:
    """Host side of one restart cycle: the Hessenberg least-squares problem,
    kept triangular column by column with complex Givens rotations, in the
    working precision."""

    def __init__(self, restart: int, beta, np_c):
        np_r = np.finfo(np_c).dtype
        self.H = np.zeros((restart + 1, restart), np_c)
        self.cs = np.zeros((restart,), np_r)
        self.sn = np.zeros((restart,), np_c)
        self.g = np.zeros((restart + 1,), np_c)
        self.g[0] = beta
        self.k = 0                      # columns so far

    def add_column(self, h: np.ndarray, hnorm):
        """Append Arnoldi column (h[0..j], hnorm); returns the residual
        norm |g[j+1]| of the enlarged problem."""
        j, cs, sn, g = self.k, self.cs, self.sn, self.g
        hcol = np.zeros((self.H.shape[0],), self.H.dtype)
        hcol[:j + 1] = h
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
        self.H[:, j] = hcol
        self.k = j + 1
        return np.abs(g[j + 1])

    def residuals(self) -> np.ndarray:
        """Residual norm after each column."""
        return np.abs(self.g[1:self.k + 1])

    def solve(self) -> np.ndarray:
        """Back-substitution on the k x k leading system."""
        k, H, g = self.k, self.H, self.g
        y = np.zeros((k,), H.dtype)
        for i in range(k - 1, -1, -1):
            y[i] = (g[i] - H[i, i + 1:k] @ y[i + 1:]) / H[i, i]
        return y


@torch.no_grad()
def gmres_batched(matvec: Callable, B: torch.Tensor, *,
                  M: Optional[Callable] = None,
                  x0: Optional[torch.Tensor] = None,
                  restart: int = 20,
                  rtol: float = 1e-3,
                  atol: float = 0.0,
                  maxiter: int = 1000,
                  iter_cap=None,
                  device="cuda") -> KrylovResult:
    """Left-preconditioned restarted GMRES on a batch B (K, N) in lockstep.

    `matvec` and `M` map a (k, N) batch to a (k, N) batch, row by row the
    same operator; they are called on the k <= K members still iterating.
    `iter_cap` caps a member's total inner iterations below `maxiter` (the
    handle for callers with a shared budget): one cap for all members or an
    array of K caps.  The inner loop respects it too, so a count never
    exceeds its cap.
    """
    dev = resolve_device(device)
    if B.device.type != dev.type:
        raise ValueError(f"B is on {B.device} but device={device!r}")
    if M is None:
        M = lambda V: V
    K, N = B.shape
    dtype = B.dtype
    np_c = np.dtype({torch.complex64: np.complex64,
                     torch.complex128: np.complex128}[dtype])
    np_r = np.finfo(np_c).dtype
    rt = np_r.type

    Mb = M(B)
    bnorm = _norms(Mb, np_r)
    tol = np.maximum(rt(rtol) * bnorm, rt(atol))
    n_outer = -(-maxiter // restart)
    history = np.full((K, n_outer * restart), np.nan, np_r)
    cap = np.full((K,), maxiter, np.int64)
    if iter_cap is not None:
        cap = np.minimum(cap, np.asarray(iter_cap, np.int64))
    happy_tol = np.finfo(np_r).eps * 100 * bnorm

    # x0 = 0 makes the initial residual Mb, already in hand for the
    # tolerance; a caller-supplied x0 pays one extra matvec + apply.
    if x0 is None:
        X = torch.zeros_like(B)
        Rv, beta = list(Mb), bnorm.copy()
    else:
        X = x0.clone()
        Rv = M(B - matvec(X))
        beta = _norms(Rv, np_r)
        Rv = list(Rv)

    iters = np.zeros((K,), np.int64)
    done = beta <= tol
    stalled = np.zeros((K,), bool)
    while True:
        # the members that run this restart cycle; Rv (a list of rows) and
        # beta hold their preconditioned residuals, carried in from the
        # previous cycle's convergence check (or the init): recomputing them
        # here would cost an extra matvec + preconditioner application per
        # restart cycle, and the apply is this workload's dominant part
        act = [i for i in range(K) if not done[i] and iters[i] < cap[i]]
        if not act:
            break
        j_limit = {i: min(restart, int(cap[i] - iters[i])) for i in act}
        V = torch.zeros((len(act), restart + 1, N), dtype=dtype,
                        device=B.device)
        lsq, res, brk = {}, {}, {}
        for p, i in enumerate(act):
            V[p, 0] = Rv[i] / (beta[i] if beta[i] > 0 else rt(1.0))
            lsq[i] = CycleLSQ(restart, beta[i], np_c)
            res[i] = beta[i]
            brk[i] = bool(beta[i] == 0.0)

        # all members of a cycle start at j = 0 and step together, so j is
        # common to those still inside the inner loop
        j = 0
        while True:
            inner = [(p, i) for p, i in enumerate(act)
                     if j < j_limit[i] and res[i] > tol[i] and not brk[i]]
            if not inner:
                break
            rows = [p for p, _ in inner]
            W = M(matvec(V[rows, j]))
            hs = []
            for q, (p, _) in enumerate(inner):
                W[q], h = arnoldi_step(V[p, :j + 1], W[q])
                hs.append(h)
            hnorms = torch.sqrt(torch.sum(W.real ** 2 + W.imag ** 2, dim=-1))
            # one host read per step: the members' columns and norms
            host = torch.cat([torch.stack(hs), hnorms.to(dtype)[:, None]],
                             dim=1).cpu().numpy()
            for q, (p, i) in enumerate(inner):
                hnorm = rt(host[q, j + 1].real)
                happy = bool(hnorm <= happy_tol[i])
                if not happy:
                    V[p, j + 1] = W[q] / hnorm
                res[i] = lsq[i].add_column(host[q, :j + 1], hnorm)
                # happy breakdown: the Krylov space is exact; the residual
                # is |g[j+1]|
                brk[i] = brk[i] or happy
            j += 1

        for p, i in enumerate(act):
            k = lsq[i].k
            history[i, iters[i]:iters[i] + k] = lsq[i].residuals()
            if k:
                X[i] = X[i] + torch.from_numpy(lsq[i].solve()).to(B.device) \
                    @ V[p, :k]
        del V

        # Convergence is decided per member on a *recomputed* preconditioned
        # residual, not the Givens estimate: in fp32 the Arnoldi recurrence
        # drifts and the estimate can undershoot by orders of magnitude.
        # The recomputed residual vector is carried into the next cycle, so
        # the trustworthy stopping test costs nothing extra.
        Rv_act = M(B[act] - matvec(X[act]))
        res_true = _norms(Rv_act, np_r)
        for p, i in enumerate(act):
            Rv[i] = Rv_act[p]
            k = lsq[i].k
            done[i] = res_true[p] <= tol[i]
            # stagnation guards: a breakdown cycle that did not converge, a
            # cycle with no residual reduction at all, or a cycle that
            # performed zero inner iterations will not improve on repeat
            stalled[i] = (not done[i]) and bool(
                brk[i] or res_true[p] >= beta[i] or k == 0
                or not np.isfinite(res_true[p]))
            beta[i] = res_true[p]
            iters[i] += k
            done[i] = done[i] or stalled[i]

    return KrylovResult(x=X, iterations=iters, converged=beta <= tol,
                        breakdown=stalled,
                        residual_norm=beta.astype(np.float64),
                        history=history)


def first_member(res: KrylovResult) -> KrylovResult:
    """The result of a batch of one, with scalar fields."""
    return KrylovResult(x=res.x[0], iterations=int(res.iterations[0]),
                        converged=bool(res.converged[0]),
                        breakdown=bool(res.breakdown[0]),
                        residual_norm=float(res.residual_norm[0]),
                        history=res.history[0])


def on_batch_of_one(fn: Optional[Callable]) -> Optional[Callable]:
    """A map of flat (N,) vectors as a map of (1, N) batches."""
    return None if fn is None else (lambda V: fn(V[0])[None])


def gmres(matvec: Callable, b: torch.Tensor, *,
          M: Optional[Callable] = None,
          x0: Optional[torch.Tensor] = None, **kw) -> KrylovResult:
    """`gmres_batched` for one right-hand side: `matvec` and `M` map flat
    (N,) vectors, `b` and `x0` are (N,), and the result's fields are
    scalars."""
    return first_member(gmres_batched(
        on_batch_of_one(matvec), b[None], M=on_batch_of_one(M),
        x0=None if x0 is None else x0[None], **kw))
