"""Vectorized stencil materialization for the Helmholtz operator, in the
5-point and the compact 9-point discretization.

All coefficients are evaluated as whole-grid tensor expressions.  The
stencil footprint is a parameter of the representation (`core.sparse`), so
the 9-point scheme is a second set of assembly functions, not a rewrite.

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
from ..core.sparse import Stencil5, Stencil9
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


# -- the 9-point scheme ---------------------------------------------------------

def _nine_point_fields(i_idx, j_idx, s2_coord, shape, n, const, eta, omega,
                       h, c_full, *, gamma, mehrstellen, fidelity, cd):
    """The nine UNMASKED coefficient fields of the 9-point scheme on the
    points (x1 = i h, x2 = j h): i_idx (n,) and j_idx (..., 1), 1-based
    integer tensors, give the points and the velocity samples; `s2_coord`,
    real and shaped like j_idx, is the layer index at which the x2
    stretching and its taper are taken (j itself for the global operator,
    the local layer for a moved-PML subgrid).  Returns the fields in
    `Stencil9` order, each expanded to `shape`.
    """
    rd = real_dtype_of(cd)
    i = i_idx.to(rd)
    l = s2_coord
    inv_h2 = 1.0 / (h * h)

    s1_m = pml.s1((i - 0.5) * h, const, eta, omega, cd)
    s1_p = pml.s1((i + 0.5) * h, const, eta, omega, cd)
    s1_c = pml.s1(i * h, const, eta, omega, cd)
    s2_m = pml.s2((l - 0.5) * h, const, eta, omega, cd)
    s2_p = pml.s2((l + 0.5) * h, const, eta, omega, cd)
    s2_c = pml.s2(l * h, const, eta, omega, cd)

    # PML taper of the diagonal branch: q == 1 (full 9-point) wherever
    # sigma == 0, q -> 0 (the consistent 5-point PML) deep in the layer
    aw = abs(complex(omega))
    q = lambda sig: 1.0 / (1.0 + (sig / aw) ** 2)
    q1_m = q(pml.sigma1((i - 0.5) * h, const, eta))
    q1_p = q(pml.sigma1((i + 0.5) * h, const, eta))
    q1_c = q(pml.sigma1(i * h, const, eta))
    q2_m = q(pml.sigma2((l - 0.5) * h, const, eta))
    q2_p = q(pml.sigma2((l + 0.5) * h, const, eta))
    q2_c = q(pml.sigma2(l * h, const, eta))
    geff = lambda qx, qy: (1.0 - (1.0 - gamma) * qx * qy).to(cd)

    cw = (geff(q1_m, q2_c) * inv_h2 * (s1_m / s2_c)).expand(shape)
    ce = (geff(q1_p, q2_c) * inv_h2 * (s1_p / s2_c)).expand(shape)
    cs = (geff(q1_c, q2_m) * inv_h2 * (s2_m / s1_c)).expand(shape)
    cn = (geff(q1_c, q2_p) * inv_h2 * (s2_p / s1_c)).expand(shape)

    # diagonal couplings at the four corner midpoints: symmetrized
    # stretching ratio (s1/s2 + s2/s1)/2 -> 1 when s == 1, weight
    # (1 - gamma_eff)/2, which tapers to zero in the PML
    def corner(s1_h, s2_h, qx, qy):
        half = 0.5 * (1.0 - geff(qx, qy)) * inv_h2
        return (half * 0.5 * (s1_h / s2_h + s2_h / s1_h)).expand(shape)

    csw = corner(s1_m, s2_m, q1_m, q2_m)
    cse = corner(s1_p, s2_m, q1_p, q2_m)
    cnw = corner(s1_m, s2_p, q1_m, q2_p)
    cne = corner(s1_p, s2_p, q1_p, q2_p)

    w2 = complex(omega) ** 2
    s12 = s1_c * s2_c
    cvel = _sample_velocity(c_full, i_idx, j_idx, fidelity)
    mass_c = w2 / (s12 * cvel.to(cd) ** 2)
    cc = -(cw + ce + cs + cn + csw + cse + cnw + cne)
    if mehrstellen:
        # Mehrstellen mass blending: e -> 1/12 per axis neighbour in the
        # interior, -> 0 in the PML (same q taper as the couplings); the
        # centre keeps 1 - sum(e) of ITS mass so the total mass weight is
        # exactly 1 everywhere.  k^2 is sampled at each mass point (clipped
        # indices; the velocity field is (n+2, n+2)).
        samp = lambda di, dj: _sample_velocity(
            c_full, torch.clamp(i_idx + di, 0, n + 1),
            torch.clamp(j_idx + dj, 0, n + 1), fidelity).to(cd)
        mass_at = lambda di, dj: w2 / (s12 * samp(di, dj) ** 2)
        e_w = (q1_m * q2_c).to(cd) / 12.0
        e_e = (q1_p * q2_c).to(cd) / 12.0
        e_s = (q1_c * q2_m).to(cd) / 12.0
        e_n = (q1_c * q2_p).to(cd) / 12.0
        cw = cw + e_w * mass_at(-1, 0)
        ce = ce + e_e * mass_at(1, 0)
        cs = cs + e_s * mass_at(0, -1)
        cn = cn + e_n * mass_at(0, 1)
        cc = cc + (1.0 - (e_w + e_e + e_s + e_n)) * mass_c
    else:
        cc = cc + mass_c
    return cc, cw, ce, cs, cn, csw, cse, cnw, cne


def _mask9(fields, bottom, top) -> Stencil9:
    """Dirichlet masking of the couplings that leave the grid: the static
    column masks, and the rows where `bottom` / `top` (boolean, shaped to
    broadcast against the fields) say the layer below / above is outside."""
    cc, cw, ce, cs, cn, csw, cse, cnw, cne = fields
    zero = torch.zeros((), dtype=cc.dtype, device=cc.device)

    def masked(f, rows=None, col=None):
        f = f.clone() if rows is None else torch.where(rows, zero, f)
        if col is not None:
            f[..., col] = 0
        return f

    return Stencil9(
        cc=cc, cw=masked(cw, col=0), ce=masked(ce, col=-1),
        cs=masked(cs, bottom), cn=masked(cn, top),
        csw=masked(csw, bottom, 0), cse=masked(cse, bottom, -1),
        cnw=masked(cnw, top, 0), cne=masked(cne, top, -1))


def build_a_stencil9_rows(rows, n, b, const, eta, omega, h, c_full, *,
                          gamma=2.0 / 3.0, mehrstellen=True,
                          fidelity="as-shipped",
                          complex_dtype=torch.complex128) -> Stencil9:
    """Assemble the band of the 9-point operator covering the grid rows
    `rows` (0-based global indices), as `build_a_stencil_rows` does for the
    5-point scheme.  `build_a_stencil9` is the rows=arange(n) case.

    The scheme blends the PML 5-point cross with a rotated (diagonal)
    cross: axis couplings are gamma times the 5-point coefficients, the
    four diagonal couplings carry weight (1-gamma)/(2h^2) times the
    symmetrized stretching ratio at the cell-corner midpoint, and the
    diagonal term keeps the mass minus the (unmasked) coupling sum.
    gamma = 1 reproduces `build_a_stencil`; gamma = 2/3 without PML gives
    the classical compact 9-point Laplacian.  Inside the absorbing layers
    the blend tapers to the pure 5-point scheme,
    gamma_eff = 1 - (1-gamma) q1 q2 with q = 1/(1 + (sigma/|omega|)^2).

    `mehrstellen=True` blends the mass term omega^2/c^2 u over the axis
    neighbours with the stencil [0 1 0; 1 8 1; 0 1 0] / 12 (k^2 sampled at
    each mass point), tapered like the corner couplings; with the matching
    right-hand-side filter `mass_filter9` the interior scheme is 4th-order
    for smooth fields.
    """
    dev = c_full.device
    rows = torch.as_tensor(rows, device=dev)
    i_idx = torch.arange(1, n + 1, device=dev)
    j_idx = (rows + 1)[:, None]
    fields = _nine_point_fields(
        i_idx, j_idx, j_idx.to(real_dtype_of(complex_dtype)),
        (rows.shape[0], n), n, const, eta, omega, h, c_full, gamma=gamma,
        mehrstellen=mehrstellen, fidelity=fidelity, cd=complex_dtype)
    return _mask9(fields, (rows == 0)[:, None], (rows == n - 1)[:, None])


def build_a_stencil9(n, b, const, eta, omega, h, c_full, *,
                     gamma=2.0 / 3.0, mehrstellen=True,
                     fidelity="as-shipped",
                     complex_dtype=torch.complex128) -> Stencil9:
    """The 9-point Helmholtz operator on the (n, n) grid
    (`build_a_stencil9_rows` for every row)."""
    return build_a_stencil9_rows(
        torch.arange(n, device=c_full.device), n, b, const, eta, omega, h,
        c_full, gamma=gamma, mehrstellen=mehrstellen, fidelity=fidelity,
        complex_dtype=complex_dtype)


def _hf9_from_band(HF: Stencil9, b: int) -> Stencil9:
    """The band of the first b layers with every coupling out of its top
    layer dropped."""
    def top_zero(f):
        f = f.clone()
        f[b - 1, :] = 0
        return f

    return Stencil9(cc=HF.cc, cw=HF.cw, ce=HF.ce, cs=HF.cs,
                    cn=top_zero(HF.cn), csw=HF.csw, cse=HF.cse,
                    cnw=top_zero(HF.cnw), cne=top_zero(HF.cne))


def build_hf_stencil9(n, b, const, eta, omega, h, c_full, *,
                      gamma=2.0 / 3.0, fidelity="corrected",
                      complex_dtype=torch.complex128) -> Stencil9:
    """H_F of the 9-point scheme assembled standalone from scalars and the
    velocity field: the same matrix `extract_hf_stencil9` slices out of an
    assembled operator."""
    HF = build_a_stencil9_rows(
        torch.arange(b, device=c_full.device), n, b, const, eta, omega, h,
        c_full, gamma=gamma, fidelity=fidelity, complex_dtype=complex_dtype)
    return _hf9_from_band(HF, b)


def extract_hf_stencil9(A: Stencil9, b: int) -> Stencil9:
    """H_F for the 9-point scheme: the true leading bn x bn principal
    submatrix of the operator (the corrected full-coupling semantics; the
    as-shipped block-diagonal variant exists only for the 5-point
    scheme)."""
    return _hf9_from_band(A.map(lambda f: f[:b]), b)


def build_hm_stencils9(n, b, const, eta, omega, h, c_full, *,
                       gamma=2.0 / 3.0, mehrstellen=True,
                       fidelity="corrected", complex_dtype=torch.complex128,
                       rows=None) -> Stencil9:
    """Moving-PML subgrid family for the 9-point scheme: batched Stencil9
    with fields (M, b, n), M = n-b: the H_m of `build_a_stencil9`'s
    discretization with the x2 stretching (and its taper) moved to sit just
    below layer m.  The s2 factors depend only on the local layer, the
    velocity samples on the global row.

    `rows` (0-based global grid rows, default arange(b, n)) restricts the
    family to those subgrids: the strided setup assembles only its sample
    rows, since nine (M, b, n) complex fields at the widths this scheme
    needs (b about n/14) are several GB.

    The subgrid boundary is Dirichlet on all sides: axis couplings masked
    at the subgrid edges, corner couplings masked on both their edges."""
    dev = c_full.device
    if rows is None:
        rows = torch.arange(b, n, device=dev)
    rows = torch.as_tensor(rows, device=dev)
    M = rows.shape[0]
    i_idx = torch.arange(1, n + 1, device=dev)
    l_idx = torch.arange(1, b + 1, device=dev)[:, None]    # local layer
    m = (rows + 1)[:, None, None]                          # subgrid top
    j_global = m - b + l_idx                               # (M, b, 1)
    fields = _nine_point_fields(
        i_idx, j_global, l_idx.to(real_dtype_of(complex_dtype)), (M, b, n),
        n, const, eta, omega, h, c_full, gamma=gamma,
        mehrstellen=mehrstellen, fidelity=fidelity, cd=complex_dtype)
    layer = torch.arange(b, device=dev)[:, None]
    return _mask9(fields, layer == 0, layer == b - 1)


def mass_filter9(n, b, const, eta, omega, h, f_grid, *, mehrstellen=True):
    """The Mehrstellen right-hand-side filter M f matching
    `build_a_stencil9(mehrstellen=True)`: the same tapered axis-neighbour
    weights (e -> 1/12 interior, -> 0 in the PML), zero outside the grid.
    The compact scheme solves A9 u = M f.  f_grid: (..., n, n); leading
    batch axes are filtered in one pass."""
    if not mehrstellen:
        return f_grid
    rd = f_grid.real.dtype
    i = torch.arange(1, n + 1, device=f_grid.device).to(rd)
    j = i[:, None]
    aw = abs(complex(omega))
    q = lambda sig: 1.0 / (1.0 + (sig / aw) ** 2)
    q1_m = q(pml.sigma1((i - 0.5) * h, const, eta))
    q1_p = q(pml.sigma1((i + 0.5) * h, const, eta))
    q1_c = q(pml.sigma1(i * h, const, eta))
    q2_m = q(pml.sigma2((j - 0.5) * h, const, eta))
    q2_p = q(pml.sigma2((j + 0.5) * h, const, eta))
    q2_c = q(pml.sigma2(j * h, const, eta))
    e_w = (q1_m * q2_c) / 12.0
    e_e = (q1_p * q2_c) / 12.0
    e_s = (q1_c * q2_m) / 12.0
    e_n = (q1_c * q2_p) / 12.0

    out = (1.0 - (e_w + e_e + e_s + e_n)) * f_grid
    out[..., :, 1:] += e_w[:, 1:] * f_grid[..., :, :-1]
    out[..., :, :-1] += e_e[:, :-1] * f_grid[..., :, 1:]
    out[..., 1:, :] += e_s[1:, :] * f_grid[..., :-1, :]
    out[..., :-1, :] += e_n[:-1, :] * f_grid[..., 1:, :]
    return out
