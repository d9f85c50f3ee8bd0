"""Stencil SpMV kernel wrapper: y = A u for the complex 5-point stencil.

Replaces the TPU kernel `_kernel` / `pallas_stencil_matvec` of the JAX
package's `ops/pallas/spmv_stencil.py`.  The CUDA source is
`csrc/spmv_stencil.cu`.

Bound: bytes.  56 B per grid point (five complex64 coefficients and u read
once, y written once) against 40 flops.  The kernel runs one thread per
point with warps along a row, so all streams are coalesced and the
neighbour reads of u hit in cache; see the source for details.

The plain version is `ops.spmv.stencil_matvec` (`plain_stencil_matvec`
here).  The wrapper takes it only for a tensor on the CPU; on a CUDA tensor
it launches the kernel or raises.
"""
from __future__ import annotations

import torch

from ...core.sparse import Stencil5
from ..spmv import stencil_matvec as plain_stencil_matvec
from . import build

#: number of kernel launches made by `stencil_matvec` in this process
launches = 0


def reset_counts() -> None:
    global launches
    launches = 0


def check_kernel_args(A: Stencil5, u: torch.Tensor) -> None:
    """What the kernel takes: complex64, contiguous (L, n) tensors on one
    device.  Raises otherwise."""
    L, n = A.grid_shape
    if u.shape != (L, n):
        raise ValueError(f"the stencil kernel takes u of shape {(L, n)}, "
                         f"got {tuple(u.shape)}")
    for name, t in (("u", u), *zip(("cc", "cw", "ce", "cs", "cn"),
                                   A.fields())):
        if t.dtype != torch.complex64:
            raise TypeError(f"the stencil kernel takes complex64, "
                            f"{name} is {t.dtype}")
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if t.shape != (L, n) or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous {(L, n)} tensor")


def stencil_matvec(A: Stencil5, u: torch.Tensor) -> torch.Tensor:
    """y = A @ u for u of grid shape (L, n)."""
    global launches
    if u.device.type != "cuda":
        return plain_stencil_matvec(A, u)
    check_kernel_args(A, u)
    L, n = A.grid_shape
    y = torch.empty_like(u)
    lib = build.library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hh_stencil_matvec(
            *(f.data_ptr() for f in A.fields()), u.data_ptr(), y.data_ptr(),
            L, n, stream)
    build.check(status, "stencil_matvec")
    launches += 1
    return y


def stencil_matvec_flat(A: Stencil5, x: torch.Tensor) -> torch.Tensor:
    """y = A @ x for a flat vector x of length L*n."""
    L, n = A.grid_shape
    return stencil_matvec(A, x.reshape(L, n)).reshape(x.shape)
