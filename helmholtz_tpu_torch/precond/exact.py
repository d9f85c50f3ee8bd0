"""Exact sweeping factorization (Engquist-Ying Algorithms 2.1/2.2).

A full block-LDL^T of the global operator by the layer Schur recursion
S_m = A_mm - A_{m,m-1} S_{m-1}^{-1} A_{m-1,m}, followed by the forward /
diagonal / backward block solve: the validation oracle among the
preconditioners, exact to rounding.  It is the moving-PML setup's machinery
(`precond.sweeping._schur_t_stack` and `_block_thomas_solve`) applied to the
whole operator instead of a b-layer subgrid: L dense n x n inverses one
after another, each a batch of one (the blocked Gauss-Jordan inverse on the
card, so the Gauss-Jordan kernel runs on one panel at a time there), and an
(L, n, n) stack of T_m = S_m^{-1}.
"""
from __future__ import annotations

import dataclasses

import torch

from ..core.sparse import BSR, Stencil5
from ..ops.dense import batched_inverse
from ..ops.sparse_algebra import bsr_spgemm
from ..ops.spmv import stencil_matvec
from .sweeping import (_block_thomas_solve, _block_thomas_solve_multi,
                       _schur_t_stack)


@dataclasses.dataclass(frozen=True)
class ExactFactorization:
    """T[m] = S_m^{-1} for every layer, plus the interlayer couplings."""

    T: torch.Tensor    # (L, n, n)
    cs: torch.Tensor   # (L, n)
    cn: torch.Tensor   # (L, n)

    def solve(self, f: torch.Tensor) -> torch.Tensor:
        """u = A^{-1} f for grid-shaped f (L, n)."""
        return _block_thomas_solve(self.T, self.cs, self.cn, f)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        L, n = self.cs.shape
        return self.solve(x.reshape(L, n)).reshape(-1)


@torch.no_grad()
def factor_exact(A: Stencil5) -> ExactFactorization:
    """Algorithm 2.1: the full layer-Schur recursion over A."""
    return ExactFactorization(T=_schur_t_stack(A), cs=A.cs, cn=A.cn)


def _elem_bsr(L: int, n: int, m: int, block: torch.Tensor,
              upper: bool) -> BSR:
    """Elementary block factor I + N with one (n, n) block at (m+1, m)
    (lower) or (m, m+1) (upper): BSR with identity diagonal blocks."""
    eye = torch.eye(n, dtype=block.dtype, device=block.device)
    extra_row, extra_col = (m, m + 1) if upper else (m + 1, m)
    blocks, cols, indptr = [], [], [0]
    for j in range(L):
        row = [(j, eye)]
        if j == extra_row:
            row.append((extra_col, block))
        row.sort(key=lambda cb: cb[0])
        cols += [c for c, _ in row]
        blocks += [b for _, b in row]
        indptr.append(len(cols))
    dev = block.device
    return BSR(torch.stack(blocks),
               torch.tensor(cols, dtype=torch.int32, device=dev),
               torch.tensor(indptr, dtype=torch.int32, device=dev),
               (L * n, L * n), (n, n))


@torch.no_grad()
def rebuild_via_spgemm(A: Stencil5, F: ExactFactorization) -> float:
    """Max |L_1..L_{n-1} D L'_{n-1}..L'_1 - A|: the factorization's
    self-check done as about 3L block-sparse products instead of dense
    N x N factors."""
    T, cs, cn = F.T, F.cs, F.cn
    L_, n = cs.shape
    D = BSR(batched_inverse(T),                    # D blocks = T_m^{-1}
            torch.arange(L_, dtype=torch.int32, device=T.device),
            torch.arange(L_ + 1, dtype=torch.int32, device=T.device),
            (L_ * n, L_ * n), (n, n))
    prod = None
    for m in range(L_ - 1):
        E = _elem_bsr(L_, n, m, cs[m + 1][:, None] * T[m], upper=False)
        prod = E if prod is None else bsr_spgemm(prod, E)
    mid = bsr_spgemm(prod, D) if prod is not None else D
    for m in range(L_ - 2, -1, -1):
        mid = bsr_spgemm(mid, _elem_bsr(L_, n, m, T[m] * cn[m][None, :],
                                        upper=True))
    A_dense = torch.as_tensor(A.todense(), device=T.device)
    return (mid.todense() - A_dense).abs().max().item()


@torch.no_grad()
def rebuild_error(A: Stencil5, F: ExactFactorization) -> float:
    """Max |A (A^{-1} I) - I| over the identity's columns: the
    factorization's self-check without dense factors (the N solves as one
    batch, then N stencil products; an N x N check for small grids)."""
    L, n = F.cs.shape
    eye = torch.eye(L * n, dtype=A.dtype, device=A.device)
    cols = stencil_matvec(A, _block_thomas_solve_multi(
        F.T, F.cs, F.cn, eye.reshape(-1, L, n)))
    return (cols.reshape(eye.shape) - eye).abs().max().item()
