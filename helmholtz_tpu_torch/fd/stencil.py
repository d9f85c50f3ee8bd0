"""Vectorized stencil materialization for the 5-point Helmholtz operator.

All coefficients are evaluated as whole-grid tensor expressions.  The
9-point assembly of the JAX package's `fd/stencil.py` is not ported yet.

Coefficient sampling points:
  cw (c1) at ((i-.5)h, jh)   with ratio s1/s2, prefactor 1/h^2
  ce (c2) at ((i+.5)h, jh)   with ratio s1/s2
  cs (c3) at (ih, (j-.5)h)   with ratio s2/s1
  cn (c4) at (ih, (j+.5)h)   with ratio s2/s1
  cc (c5) at (ih, jh):  omega^2/(s1*s2*c^2) - (c1+c2+c3+c4)
where the c1..c4 in the cc sum are the *unmasked* values (computed at every
point, including boundary points whose couplings are dropped).
"""
from __future__ import annotations

import torch

from .._device import real_dtype_of
from ..core.sparse import Stencil5
from . import pml


def _sample_velocity(c_full, i, j, fidelity):
    """Velocity value used at stencil point (x1=i*h, x2=j*h).

    `c_full` is the (n+2, n+2) velocity field with [row, col] = c(x=col*h,
    y=row*h).  i, j are 1-based integer index tensors broadcastable to the
    output grid shape.

    "as-shipped" reproduces the original code's `c_mat[i-1, j-1]` read: the
    velocity is sampled transposed and shifted one grid point.  "corrected"
    samples the true point: row=j (y=x2), col=i (x=x1).
    """
    if fidelity == "as-shipped":
        return c_full[i - 1, j - 1]
    elif fidelity == "corrected":
        return c_full[j, i]
    raise ValueError(f"unknown fidelity {fidelity!r}")


def build_a_stencil_rows(rows, n, b, const, eta, omega, h, c_full, *,
                         fidelity="as-shipped",
                         complex_dtype=torch.complex128) -> Stencil5:
    """Assemble the band of the global operator A covering the grid rows
    `rows` (0-based global row indices, an integer tensor of shape (L_loc,)).

    `build_a_stencil` is the rows=arange(n) special case; H_F is the
    rows=arange(b) band.
    """
    cd = complex_dtype
    rd = real_dtype_of(cd)
    dev = c_full.device
    rows = torch.as_tensor(rows, device=dev)
    i_idx = torch.arange(1, n + 1, device=dev)      # in-layer (x1), 1-based
    j_idx = (rows + 1)[:, None]                     # layer (x2), 1-based
    i = i_idx.to(rd)
    j = j_idx.to(rd)
    inv_h2 = 1.0 / (h * h)

    s1_m = pml.s1((i - 0.5) * h, const, eta, omega, cd)   # (n,)
    s1_p = pml.s1((i + 0.5) * h, const, eta, omega, cd)
    s1_c = pml.s1(i * h, const, eta, omega, cd)
    s2_m = pml.s2((j - 0.5) * h, const, eta, omega, cd)   # (L_loc, 1)
    s2_p = pml.s2((j + 0.5) * h, const, eta, omega, cd)
    s2_c = pml.s2(j * h, const, eta, omega, cd)

    L_loc = rows.shape[0]
    shape = (L_loc, n)
    cw = (inv_h2 * (s1_m / s2_c)).expand(shape)
    ce = (inv_h2 * (s1_p / s2_c)).expand(shape)
    cs = (inv_h2 * (s2_m / s1_c)).expand(shape)
    cn = (inv_h2 * (s2_p / s1_c)).expand(shape)

    cvel = _sample_velocity(c_full, i_idx[None, :], j_idx, fidelity)
    cc = complex(omega) ** 2 / (s1_c[None, :] * s2_c * cvel.to(cd) ** 2) \
        - (cw + ce + cs + cn)

    # Dirichlet masking: zero couplings that leave the grid.  Row masks are
    # data-dependent on the global row index (the band may sit anywhere).
    cw = cw.clone()
    cw[:, 0] = 0
    ce = ce.clone()
    ce[:, -1] = 0
    zero = torch.zeros((), dtype=cd, device=dev)
    cs = torch.where((rows == 0)[:, None], zero, cs)
    cn = torch.where((rows == n - 1)[:, None], zero, cn)
    return Stencil5(cc=cc, cw=cw, ce=ce, cs=cs, cn=cn)


def build_a_stencil(n, b, const, eta, omega, h, c_full, *,
                    fidelity="as-shipped",
                    complex_dtype=torch.complex128) -> Stencil5:
    """Assemble the global Helmholtz operator A as a Stencil5 on the (n, n)
    grid.  A is complex-symmetric, 5-diagonal (offsets 0, +-1, +-n),
    nnz = 5n^2-4n."""
    return build_a_stencil_rows(torch.arange(n, device=c_full.device), n, b,
                                const, eta, omega, h, c_full,
                                fidelity=fidelity,
                                complex_dtype=complex_dtype)


def build_hm_stencils_rows(rows, n, b, const, eta, omega, h, c_full, *,
                           fidelity="as-shipped",
                           complex_dtype=torch.complex128) -> Stencil5:
    """Assemble the moving-PML subgrid family ROW-ALIGNED: entry k is the
    H_m whose corner inverse acts on global grid row rows[k] (0-based),
    i.e. m = rows[k] + 1 (1-based subgrid top).  Fields (L_loc, b, n).

    For F-band rows (rows[k] < b) there is no subgrid; m is clamped to b+1
    so the entry is a valid (factorable) matrix.
    """
    cd = complex_dtype
    rd = real_dtype_of(cd)
    dev = c_full.device
    rows = torch.as_tensor(rows, device=dev)
    M = rows.shape[0]
    i_idx = torch.arange(1, n + 1, device=dev)           # in-layer, 1-based
    l_idx = torch.arange(1, b + 1, device=dev)[:, None]  # local layer
    i = i_idx.to(rd)
    l = l_idx.to(rd)
    # subgrid top m = row+1, clamped to the first real subgrid for F rows
    m = torch.clamp(rows + 1, min=b + 1)[:, None, None]
    inv_h2 = 1.0 / (h * h)

    s1_m = pml.s1((i - 0.5) * h, const, eta, omega, cd)
    s1_p = pml.s1((i + 0.5) * h, const, eta, omega, cd)
    s1_c = pml.s1(i * h, const, eta, omega, cd)
    # moved PML: s2m at global x2 = j*h equals s2 at local l*h.
    s2_m = pml.s2((l - 0.5) * h, const, eta, omega, cd)   # (b, 1)
    s2_p = pml.s2((l + 0.5) * h, const, eta, omega, cd)
    s2_c = pml.s2(l * h, const, eta, omega, cd)

    shape = (M, b, n)
    cw = (inv_h2 * (s1_m / s2_c)).expand(shape)
    ce = (inv_h2 * (s1_p / s2_c)).expand(shape)
    cs = (inv_h2 * (s2_m / s1_c)).expand(shape)
    cn = (inv_h2 * (s2_p / s1_c)).expand(shape)

    j_global = m - b + l_idx                         # (M, b, 1), 1-based
    cvel = _sample_velocity(c_full, i_idx[None, None, :], j_global, fidelity)
    cc = complex(omega) ** 2 / (s1_c[None, None, :] * s2_c[None]
                                * cvel.to(cd) ** 2) \
        - (cw + ce + cs + cn)

    cw = cw.clone()
    cw[:, :, 0] = 0
    ce = ce.clone()
    ce[:, :, -1] = 0
    cs = cs.clone()
    cs[:, 0, :] = 0
    cn = cn.clone()
    cn[:, -1, :] = 0
    return Stencil5(cc=cc, cw=cw, ce=ce, cs=cs, cn=cn)


def build_hm_stencils(n, b, const, eta, omega, h, c_full, *,
                      fidelity="as-shipped",
                      complex_dtype=torch.complex128) -> Stencil5:
    """Assemble the whole moving-PML subgrid family {H_m : m = b+1..n} in one
    shot as a batched Stencil5 with fields of shape (M, b, n), M = n-b.

    The moved stretching s2m(j*h) = s2(l*h) depends only on the *local*
    layer index l = j-(m-b) in 1..b, so the s2 factors are shared by every
    m; only the velocity samples vary with m.

    Batch index mi corresponds to m = b+1+mi (entry mi acts on global grid
    row b+mi, 0-based); the subgrid boundary is Dirichlet on all sides.
    """
    return build_hm_stencils_rows(
        torch.arange(b, n, device=c_full.device), n, b, const, eta, omega, h,
        c_full, fidelity=fidelity, complex_dtype=complex_dtype)


def _hf_from_band(HF: Stencil5, b: int, full_coupling: bool) -> Stencil5:
    cs = HF.cs
    cn = HF.cn.clone()
    cn[b - 1, :] = 0
    if not full_coupling:
        cs = torch.zeros_like(cs)
        cn = torch.zeros_like(cn)
    return Stencil5(cc=HF.cc, cw=HF.cw, ce=HF.ce, cs=cs, cn=cn)


def build_hf_stencil(n, b, const, eta, omega, h, c_full, *,
                     full_coupling: bool = True,
                     fidelity="as-shipped",
                     complex_dtype=torch.complex128) -> Stencil5:
    """H_F assembled standalone from scalars + the velocity field: the same
    matrix `extract_hf_stencil` slices out of an assembled A."""
    HF = build_a_stencil_rows(torch.arange(b, device=c_full.device), n, b,
                              const, eta, omega, h, c_full,
                              fidelity=fidelity, complex_dtype=complex_dtype)
    return _hf_from_band(HF, b, full_coupling)


def extract_hf_stencil(A: Stencil5, b: int, *,
                       full_coupling: bool = True) -> Stencil5:
    """H_F: the operator on the first b layers.

    With `full_coupling=True` (the corrected semantics) this is the true
    leading bn x bn principal submatrix of A: the layer slice with the
    coupling out of the top layer dropped.  With `full_coupling=False` it
    reproduces the as-shipped block-diagonal variant (all interlayer
    couplings dropped).
    """
    return _hf_from_band(A.map(lambda f: f[:b]), b, full_coupling)
