"""Sparse matrix-vector and matrix-matrix products.

`stencil_matvec` is the plain version of the CUDA kernel in
`ops.kernels.spmv_stencil`: the CPU tests run it, and the kernel is held
against it on the card.  `stencil9_matvec`, the 9-point product, has no
kernel on either side: the JAX package leaves it to its compiler, and here
it is nine shifted multiply-adds on any device.

The generic formats: `coo_matvec`, `csr_matvec` and `csr_matmat` are plain
tensor code on any device (the JAX package has no kernel for them either);
`bsr_matmat` and `bsr_matvec` run the BSR kernel (`ops.kernels.bsr_spmm`)
on the card and its plain version on the CPU.
"""
from __future__ import annotations

import torch

from ..core.sparse import BSR, COO, CSR, Stencil5, Stencil9
from .kernels import bsr_spmm


def stencil_matvec(A: Stencil5, u: torch.Tensor) -> torch.Tensor:
    """y = A @ u with u of grid shape (..., L, n).

    Five shifted element-wise multiply-adds; masked boundary coefficients
    are zero, and the shifted terms simply do not reach past the grid edge,
    which realizes the Dirichlet boundary.
    """
    y = A.cc * u
    y[..., :, 1:] += A.cw[..., :, 1:] * u[..., :, :-1]     # u[j, i-1]
    y[..., :, :-1] += A.ce[..., :, :-1] * u[..., :, 1:]    # u[j, i+1]
    y[..., 1:, :] += A.cs[..., 1:, :] * u[..., :-1, :]     # u[j-1, i]
    y[..., :-1, :] += A.cn[..., :-1, :] * u[..., 1:, :]    # u[j+1, i]
    return y


def stencil_matvec_flat(A: Stencil5, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a flat vector x of length L*n (or batch (..., L*n))."""
    L, n = A.grid_shape
    u = x.reshape(*x.shape[:-1], L, n)
    return stencil_matvec(A, u).reshape(x.shape)


def _shift2(u, dj, di):
    """u shifted so that result[..., j, i] = u[..., j+dj, i+di], zero
    outside the grid."""
    L, n = u.shape[-2:]
    out = torch.zeros_like(u)
    rows = slice(max(0, -dj), L - max(0, dj))
    cols = slice(max(0, -di), n - max(0, di))
    src_rows = slice(max(0, dj), L - max(0, -dj))
    src_cols = slice(max(0, di), n - max(0, -di))
    out[..., rows, cols] = u[..., src_rows, src_cols]
    return out


def stencil9_matvec(A: Stencil9, u: torch.Tensor) -> torch.Tensor:
    """y = A @ u for the 9-point footprint, u of grid shape (..., L, n): the
    pattern of `stencil_matvec` with four more shifted multiply-adds."""
    out = A.cc * u
    for f, (dj, di) in zip(A.fields()[1:], Stencil9.OFFSETS[1:]):
        out += f * _shift2(u, dj, di)
    return out


def stencil9_matvec_flat(A: Stencil9, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a flat vector x of length L*n (or batch (..., L*n))."""
    L, n = A.grid_shape
    u = x.reshape(*x.shape[:-1], L, n)
    return stencil9_matvec(A, u).reshape(x.shape)


def coo_matvec(A: COO, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x by scatter-add over the stored entries."""
    contrib = A.data * x[A.col.long()]
    out = torch.zeros(A.shape[0], dtype=contrib.dtype, device=x.device)
    return out.index_add_(0, A.row.long(), contrib)


def csr_matvec(A: CSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x by a segment sum over the rows."""
    contrib = A.data * x[A.indices.long()]
    out = torch.zeros(A.shape[0], dtype=contrib.dtype, device=x.device)
    return out.index_add_(0, A.rows(), contrib)


def csr_matmat(A: CSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X of shape (ncols, k)."""
    contrib = A.data[:, None] * X[A.indices.long()]
    out = torch.zeros((A.shape[0], X.shape[1]), dtype=contrib.dtype,
                      device=X.device)
    return out.index_add_(0, A.rows(), contrib)


def bsr_matmat(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X of shape (ncols, k): the BSR kernel."""
    return bsr_spmm.bsr_matmat(A, X.contiguous())


def bsr_matvec(A: BSR, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x: the BSR kernel with one column."""
    return bsr_spmm.bsr_matmat(A, x.reshape(-1, 1).contiguous()).reshape(
        A.shape[0])
