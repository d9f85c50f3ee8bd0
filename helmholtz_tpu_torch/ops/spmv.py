"""Stencil matrix-vector product in plain PyTorch.

This is the plain version of the CUDA kernel in `ops.kernels.spmv_stencil`:
the CPU tests run it, and the kernel is held against it on the card.
"""
from __future__ import annotations

import torch

from ..core.sparse import Stencil5


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
