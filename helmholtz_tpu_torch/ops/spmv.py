"""Stencil matrix-vector products in plain PyTorch.

`stencil_matvec` is the plain version of the CUDA kernel in
`ops.kernels.spmv_stencil`: the CPU tests run it, and the kernel is held
against it on the card.  `stencil9_matvec`, the 9-point product, has no
kernel on either side: the JAX package leaves it to its compiler, and here
it is nine shifted multiply-adds on any device.
"""
from __future__ import annotations

import torch

from ..core.sparse import Stencil5, Stencil9


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
