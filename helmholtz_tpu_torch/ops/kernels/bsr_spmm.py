"""Block-sparse times dense kernel wrapper: Y = A X for a complex BSR matrix
A and a dense X.

Replaces the TPU kernel `_kernel` / `pallas_bsr_matmat` of the JAX package's
`ops/pallas/bsr_spmm.py`.  The CUDA source is `csrc/bsr_spmm.cu`.

Bound: bytes.  Every stored block is read once, X and Y once, against
8 * nblocks * bm * bn * K operations; see the source note.  Empty block rows
give zero rows; any block size and any K >= 1 are taken.

The plain version is `plain_bsr_matmat`, the JAX package's segment-sum
formulation (`ops/spmv.bsr_matmat`): one batched product over the stored
blocks and an `index_add_` into the block rows.  The wrapper takes it only
for tensors on the CPU; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ...core.sparse import BSR
from . import build

#: number of kernel launches made by `bsr_matmat` in this process
launches = 0


def reset_counts() -> None:
    global launches
    launches = 0


def plain_bsr_matmat(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K): the stored blocks times the
    matching block rows of X, summed into the block rows of Y."""
    bm, bn = A.blocksize
    K = X.shape[1]
    Xb = X.reshape(-1, bn, K)
    contrib = torch.bmm(A.data, Xb[A.indices.long()])        # (nb, bm, K)
    out = torch.zeros((A.shape[0] // bm, bm, K),
                      dtype=torch.result_type(A.data, X), device=X.device)
    out.index_add_(0, A.block_rows(), contrib)
    return out.reshape(A.shape[0], K)


def check_kernel_args(A: BSR, X: torch.Tensor) -> None:
    """What the kernel takes: complex64 contiguous blocks (nblocks, bm, bn)
    and X (ncols, K), int32 indices and indptr, all on X's device.  Raises
    otherwise."""
    bm, bn = A.blocksize
    M, N = A.shape
    if X.ndim != 2 or X.shape[0] != N or X.shape[1] < 1:
        raise ValueError(f"the BSR kernel takes X of shape ({N}, K), got "
                         f"{tuple(X.shape)}")
    if M % bm or N % bn or A.data.shape[1:] != (bm, bn):
        raise ValueError(f"blocks {tuple(A.data.shape)} do not tile the "
                         f"shape {A.shape} by {A.blocksize}")
    if A.indptr.shape != (M // bm + 1,) \
            or A.indices.shape != (A.data.shape[0],):
        raise ValueError("indptr / indices do not match the block layout")
    for name, t, dtype in (("data", A.data, torch.complex64),
                           ("X", X, torch.complex64),
                           ("indices", A.indices, torch.int32),
                           ("indptr", A.indptr, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"the BSR kernel takes {name} as {dtype}, got "
                            f"{t.dtype}")
        if t.device != X.device:
            raise ValueError(f"{name} is on {t.device}, X on {X.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def bsr_matmat(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X of shape (ncols, K); (nrows, K)."""
    global launches
    if X.device.type != "cuda":
        return plain_bsr_matmat(A, X)
    check_kernel_args(A, X)
    bm, bn = A.blocksize
    Y = torch.empty((A.shape[0], X.shape[1]), dtype=X.dtype,
                    device=X.device)
    lib = build.library()
    with torch.cuda.device(X.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hh_bsr_spmm(
            A.data.data_ptr(), A.indices.data_ptr(), A.indptr.data_ptr(),
            X.data_ptr(), Y.data_ptr(), A.shape[0] // bm, bm, bn,
            X.shape[1], stream)
    build.check(status, "bsr_matmat")
    launches += 1
    return Y
