"""Gauss-Jordan panel-inverse kernel wrapper: the base case of the blocked
inverse of the preconditioner setup.

Replaces the TPU kernel `_kernel` / `pallas_gj_inverse` of the JAX package's
`ops/pallas/gj_inverse.py`.  The CUDA source is `csrc/gj_inverse.cu`.

Computes the unpivoted Gauss-Jordan inverse of every (k, k) complex64 matrix
of a (B, k, k) batch, k <= 128: k rank-1 elimination steps, one block per
matrix, the panel held in registers (each thread a fixed tile of it) in a
template width of 32, 64 or 128 with an identity tail, and one barrier a
step.

Bound: operations.  8 k^3 float32 operations a matrix on the CUDA cores
against 16 k^2 bytes; at a batch of one the floor is one launch and k
dependent steps on one SM, so the design cuts a step's latency; see the
source note.

The plain version is `gauss_jordan_inverse_unpivoted`, the loop of k rank-1
updates on tensors that the JAX package runs through its compiler.  The
wrapper takes it only for a tensor on the CPU; on a CUDA tensor it launches
the kernel or raises.
"""
from __future__ import annotations

import torch

from . import build

#: the largest panel the kernel takes, as the TPU kernel's contract
MAX_K = 128

#: number of kernel launches made by `gj_inverse` in this process
launches = 0


def reset_counts() -> None:
    global launches
    launches = 0


def gauss_jordan_inverse_unpivoted(A: torch.Tensor) -> torch.Tensor:
    """Scalar Gauss-Jordan inverse without pivoting, batched over leading
    dims: k rank-1 updates.  Only for matrices that need no row exchanges
    (diagonally dominant or damped blocks)."""
    X = A.clone()
    for j in range(X.shape[-1]):
        col = X[..., :, j:j + 1].clone()                     # (..., k, 1)
        pivot = col[..., j:j + 1, :]                        # (..., 1, 1)
        prow = X[..., j:j + 1, :] / pivot                   # (..., 1, k)
        X -= col * prow
        X[..., :, j:j + 1] = -col / pivot
        X[..., j:j + 1, :] = prow
        X[..., j, j] = 1.0 / pivot[..., 0, 0]
    return X


def check_kernel_args(A: torch.Tensor) -> None:
    """What the kernel takes: a contiguous (B, k, k) complex64 tensor with
    k <= MAX_K.  Raises otherwise."""
    if A.dtype != torch.complex64:
        raise TypeError(f"the Gauss-Jordan kernel takes complex64, got "
                        f"{A.dtype}")
    if A.ndim != 3 or A.shape[1] != A.shape[2]:
        raise ValueError(f"the Gauss-Jordan kernel takes (B, k, k), got "
                         f"{tuple(A.shape)}")
    if not 1 <= A.shape[1] <= MAX_K or A.shape[0] < 1:
        raise ValueError(f"the Gauss-Jordan kernel takes 1 <= k <= {MAX_K} "
                         f"and B >= 1, got {tuple(A.shape)}")
    if not A.is_contiguous():
        raise ValueError("the Gauss-Jordan kernel takes a contiguous tensor")


def gj_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of every matrix of a (B, k, k) batch, k <= 128."""
    global launches
    if A.device.type != "cuda":
        return gauss_jordan_inverse_unpivoted(A)
    check_kernel_args(A)
    out = torch.empty_like(A)
    lib = build.library()
    with torch.cuda.device(A.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hh_gj_inverse(A.data_ptr(), out.data_ptr(), A.shape[0],
                                   A.shape[1], stream)
    build.check(status, "gj_inverse")
    launches += 1
    return out
