"""Batched dense complex linear algebra.

The Schur complements inverted by the preconditioner setup are
complex-shifted, PML-damped Helmholtz blocks.  The JAX package inverts them
with an unpivoted blocked Gauss-Jordan on the TPU and with pivoted LAPACK on
the CPU; the port calls `torch.linalg.inv` (pivoted LU through the vendor
library) on both devices.  A blocked inverse of the port's own, and the
Gauss-Jordan panel kernel behind it, are still to be ported.
"""
from __future__ import annotations

import torch


def batched_inverse(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of square matrices (..., n, n)."""
    return torch.linalg.inv(A)
