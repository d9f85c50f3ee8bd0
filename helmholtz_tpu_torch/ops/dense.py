"""Batched dense complex linear algebra.

The Schur complements inverted by the preconditioner setup are
complex-shifted, PML-damped Helmholtz blocks, far from needing global
pivoting.  On the card `batched_inverse` therefore runs the JAX package's
blocked Gauss-Jordan without cross-panel pivoting: panels 256 wide, then 64
wide, and on panels of 64 or fewer the Gauss-Jordan kernel
(`ops.kernels.gj_inverse`, K3); the three panel products of each step are
batched complex64 matrix products in full float32; any other type reaches
the kernel's argument check and raises.  On the CPU and with `pivoted=True`
it calls `torch.linalg.inv` (pivoted LU), as the JAX package calls LAPACK on
the CPU.
"""
from __future__ import annotations

import torch

from .kernels.gj_inverse import gj_inverse


def batched_inverse(A: torch.Tensor, *, block: int = 256,
                    pivoted: bool = False) -> torch.Tensor:
    """Inverse of a batch of square matrices (..., n, n)."""
    if pivoted or A.device.type != "cuda":
        return torch.linalg.inv(A)
    n = A.shape[-1]
    X = _blocked_gj(A.reshape(-1, n, n), block)
    return X.reshape(A.shape)


def _blocked_gj(A: torch.Tensor, block: int) -> torch.Tensor:
    """Blocked Gauss-Jordan inverse of a (B, n, n) batch, the recursion of
    the JAX package's `_blocked_gj`: panel width min(block, max(64,
    ceil(n/2))), inner panels max(64, nb // 4), an identity tail padding n
    to a multiple of the panel, and at n <= 64 the scalar Gauss-Jordan (the
    kernel on the card, its plain version on the CPU).  Returns a (B, n, n)
    tensor, a view into the padded work matrix when n was padded."""
    B, n, _ = A.shape
    if n <= 64:
        return gj_inverse(A.contiguous())
    nb = min(block, max(64, -(-n // 2)))
    n_pad = -(-n // nb) * nb
    X = torch.zeros((B, n_pad, n_pad), dtype=A.dtype, device=A.device)
    X[:, :n, :n] = A
    X[:, n:, n:].diagonal(dim1=-2, dim2=-1).fill_(1)
    for kb in range(0, n_pad, nb):
        panel = slice(kb, kb + nb)
        P = _blocked_gj(X[:, panel, panel], max(64, nb // 4))
        rowk = torch.bmm(P, X[:, panel, :])                    # (B, nb, n)
        colk = X[:, :, panel].clone()                         # (B, n, nb)
        X.baddbmm_(colk, rowk, alpha=-1)
        X[:, :, panel] = torch.bmm(colk, P).neg_()
        X[:, panel, :] = rowk
        X[:, panel, panel] = P
        del P, rowk, colk
    return X[:, :n, :n] if n_pad != n else X
