"""The operator product on a band of rows, with the halo exchange.

The +-n diagonals of A couple adjacent layer blocks, so each band needs
one boundary row from each neighbour per product.  The exchange is posted
first (`dist.comm.exchange_halo`); the interior product runs on the rows
the rank holds with zero halos; then the two received rows are added to
the band's first and last rows.  The ranks at the ends of the domain
receive zeros, which realizes the Dirichlet condition because the masked
boundary couplings are zero as well.

On the 5-point scheme the interior product is the stencil kernel (K1,
`ops.kernels.spmv_stencil`) on the band's fields: its zero-halo treatment
of the band's edge rows is exactly the interior part.  The kernel takes
one grid, so a batch of right-hand sides is one exchange and one launch
per member.  The 9-point product is plain tensor code, as on one card.
"""
from __future__ import annotations

import torch

from ..core.sparse import Stencil5, Stencil9
from ..ops import spmv as plain_spmv
from ..ops.kernels.spmv_stencil import stencil_matvec
from . import comm

#: 5-point band products of one grid made in this process (each one
#: launch of the stencil kernel on the card)
band_products = 0


def reset_counts() -> None:
    global band_products
    band_products = 0


def _shw(v):
    """v[..., i-1], zero at i = 0."""
    out = torch.zeros_like(v)
    out[..., 1:] = v[..., :-1]
    return out


def _she(v):
    """v[..., i+1], zero at i = n-1."""
    out = torch.zeros_like(v)
    out[..., :-1] = v[..., 1:]
    return out


def halo_stencil_matvec(mesh, A: Stencil5, u: torch.Tensor,
                        interior=None) -> torch.Tensor:
    """y = (A u) on this rank's band: A the band's Stencil5 (n_loc, n), u
    (n_loc, n) or a batch (B, n_loc, n).  `interior` is the zero-halo band
    product (default: the stencil kernel's wrapper, one grid at a time)."""
    global band_products
    halo = comm.exchange_halo(mesh, u)
    if interior is None:
        interior = stencil_matvec
        if u.ndim == 3:
            y = torch.stack([interior(A, v) for v in u])
        else:
            y = interior(A, u)
        band_products += u.shape[0] if u.ndim == 3 else 1
    else:
        y = interior(A, u)
    below, above = halo.wait()
    y[..., 0, :] += A.cs[0] * below
    y[..., -1, :] += A.cn[-1] * above
    return y


def halo_stencil9_matvec(mesh, A: Stencil9, u: torch.Tensor) -> torch.Tensor:
    """y = (A9 u) on this rank's band: `halo_stencil_matvec` with the four
    corner couplings, which read the same halo rows shifted within the
    row, so one row still travels each way."""
    halo = comm.exchange_halo(mesh, u)
    y = plain_spmv.stencil9_matvec(A, u)
    below, above = halo.wait()
    y[..., 0, :] += (A.cs[0] * below + A.csw[0] * _shw(below)
                     + A.cse[0] * _she(below))
    y[..., -1, :] += (A.cn[-1] * above + A.cnw[-1] * _shw(above)
                      + A.cne[-1] * _she(above))
    return y


def halo_matvec(mesh, A, u: torch.Tensor) -> torch.Tensor:
    """The band product of either stencil."""
    if isinstance(A, Stencil9):
        return halo_stencil9_matvec(mesh, A, u)
    return halo_stencil_matvec(mesh, A, u)


def halo_matvec_hi(mesh, A, u: torch.Tensor) -> torch.Tensor:
    """The band product in complex128 on A's coefficients widened, plain
    PyTorch on either stencil: the refinement's residual (the counterpart of
    the JAX package's halo-exchanged compensated residual)."""
    A_hi = A.map(lambda f: f.to(torch.complex128))
    u = u.to(torch.complex128)
    if isinstance(A, Stencil9):
        return halo_stencil9_matvec(mesh, A_hi, u)
    return halo_stencil_matvec(mesh, A_hi, u,
                               interior=plain_spmv.stencil_matvec)
