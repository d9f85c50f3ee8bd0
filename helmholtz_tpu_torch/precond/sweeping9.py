"""Moving-PML sweeping preconditioner for the 9-POINT discretization.

The 5-point module (`precond.sweeping`) exploits that the operator's
inter-layer coupling blocks are DIAGONAL, so the layer-Schur update is a
row/column scaling.  The 9-point scheme (`fd.stencil.build_a_stencil9`) adds
the four corner couplings, which makes the inter-layer blocks TRIDIAGONAL:

    layer block row j:  [ L_j | D_j | U_j ]
    D_j = tridiag(cw, cc, ce)_j          (within-layer)
    L_j = tridiag(csw, cs, cse)_j        (to layer j-1)
    U_j = tridiag(cnw, cn, cne)_j        (to layer j+1)

Everything in the Engquist-Ying construction survives with tridiagonal
couplings at the SAME cost structure: the Schur update
S_l = D_l - L_l T_{l-1} U_{l-1} is two O(n^2) shifted-row/column passes
around the dense T (no extra O(n^3)), the sweep's coupling applications are
O(n) tridiagonal products, and the corner inverse G_m is still one dense
(n, n) block per subgrid.  So the chunk/stride machinery and the G storage
formats of the 5-point path are reused as they are
(`factor_corner_inverses(corner_fn=...)`), and so is the apply
(`sweeping.apply_preconditioner`): the state's coupling rows are (.., 3, n)
[sub, diag, sup], and their rank selects the tridiagonal products in the
block-Thomas solve and the sweep kernel's tridiagonal-coupling mode.

PML width: the 9-point subgrid needs a WIDER moved PML than the 5-point
scheme's b = 12, because the tapered diagonal branch leaves only the 5-point
part absorbing; b about n/14 with C about 60 keeps iteration counts flat
(`driver.min_pml_width9`).  The apply's cost does not depend on b through G
(G is (M, n, n) regardless), but the two block-Thomas solves of H_F and the
setup's layer recursion scale with it.

The shifted adds below update their result in place (`addcmul_` on slices):
nothing else holds a reference to it.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from .._device import resolve_device
from ..core.sparse import Stencil9
from ..fd import stencil as fd_stencil
from ..ops.dense import batched_inverse
from ..ops.kernels.sweep import g_ld
from .sweeping import (DEFAULT_SETUP_CHUNK, _add_tridiag_, _check_g_tables,
                       _clamped_chunk, _dense_tridiag, _g_tables,
                       apply_preconditioner, apply_preconditioner_multi,
                       expand_strided_samples, factor_corner_inverses,
                       sample_positions)


def _tridiag_rmatmul(X, sub, diag, sup):
    """Y = X @ tridiag(sub, diag, sup): columns of Y combine adjacent
    columns of X, Y[..., j] = X[..., j-1] sup_{j-1} + X[..., j] diag_j
    + X[..., j+1] sub_{j+1}.  O(n^2) shifted adds, no tridiagonal matrix is
    built.  X (..., n, n), coupling rows (..., n)."""
    Y = X * diag[..., None, :]
    Y[..., :, 1:].addcmul_(X[..., :, :-1], sup[..., None, :-1])
    Y[..., :, :-1].addcmul_(X[..., :, 1:], sub[..., None, 1:])
    return Y


def _tridiag_lmatmul(sub, diag, sup, X):
    """Y = tridiag(sub, diag, sup) @ X: rows of Y combine adjacent rows of
    X."""
    Y = diag[..., :, None] * X
    Y[..., 1:, :].addcmul_(sub[..., 1:, None], X[..., :-1, :])
    Y[..., :-1, :].addcmul_(sup[..., :-1, None], X[..., 1:, :])
    return Y


def _schur_steps9(H: Stencil9):
    """The layer-Schur recursion with TRIDIAGONAL couplings,
    S_l = D_l - L_l T_{l-1} U_{l-1}: yields T_l = S_l^{-1} for l = 0..L-1,
    each (..., n, n).  The one recursion behind the corner inverse and the
    full stack."""
    at = lambda f, l: f[..., l, :]
    T = batched_inverse(_dense_tridiag(at(H.cw, 0), at(H.cc, 0),
                                       at(H.ce, 0)))
    yield T
    for l in range(1, H.cc.shape[-2]):
        W = _tridiag_lmatmul(at(H.csw, l), at(H.cs, l), at(H.cse, l), T)
        S = _tridiag_rmatmul(W, at(H.cnw, l - 1), at(H.cn, l - 1),
                             at(H.cne, l - 1)).neg_()
        del W
        T = batched_inverse(
            _add_tridiag_(S, at(H.cw, l), at(H.cc, l), at(H.ce, l)))
        yield T


def _schur_corner_inverse9(H: Stencil9):
    """T_{L-1} = S_{L-1}^{-1} for a batched 9-point subgrid family (fields
    (..., L, n)); peak memory a few (batch, n, n)."""
    for T in _schur_steps9(H):
        pass
    return T


def _schur_t_stack9(H: Stencil9):
    """All layer Schur-complement inverses T_l (the H_F block-Thomas stack
    of the 9-point scheme): (..., L, n, n)."""
    return torch.stack(list(_schur_steps9(H)), dim=-3)


@dataclasses.dataclass(frozen=True)
class SweepingPreconditioner9:
    """Factored 9-point moving-PML sweeping state.

    G_re, G_im : (M, n, ld) corner inverses, exactly the 5-point state's
           layout (`precond.sweeping.SweepingPreconditioner`).
    TF   : (b, n, n) complex block-Thomas stack for H_F, its VALUES rounded
           to the G storage type as the reference package's are (so
           iteration counts match it), held widened to the working complex
           type: one conversion at setup instead of one per Thomas step.
           At n = 1023, b = 74 that is 0.62 GB in complex64 (two bfloat16
           planes would be 0.31 GB).
    hf_l / hf_u : H_F lower / upper coupling rows, (b, 3, n) as
           [sub, diag, sup].
    a_l / a_u   : the global operator's coupling rows, (L, 3, n).
    g_w, g_lo, g_stride : sample-compressed G, as in the 5-point state.
    """

    G_re: torch.Tensor
    G_im: torch.Tensor
    TF: torch.Tensor
    hf_l: torch.Tensor
    hf_u: torch.Tensor
    a_l: torch.Tensor
    a_u: torch.Tensor
    b: int
    d2_replace: bool
    g_w: torch.Tensor | None = None
    g_lo: torch.Tensor | None = None
    g_stride: int = 0

    def __post_init__(self):
        _check_g_tables(self)

    @property
    def grid_shape(self):
        return (self.a_l.shape[0], self.a_l.shape[-1])

    @property
    def couplings(self):
        """(hf_lo, hf_up, a_lo, a_up) as `sweeping.apply_rows` takes
        them."""
        return self.hf_l, self.hf_u, self.a_l, self.a_u

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """LinearOperator-style matvec on a flat (N,) vector."""
        L, n = self.grid_shape
        return apply_preconditioner(self, x.reshape(L, n)).reshape(-1)

    def apply_multi(self, X: torch.Tensor) -> torch.Tensor:
        """The same for a batch of flat vectors, (B, N) -> (B, N): the whole
        batch rides one stream of G per sweep (in launches of at most four
        right-hand sides, `sweeping.apply_preconditioner_multi`)."""
        L, n = self.grid_shape
        B = X.shape[0]
        return apply_preconditioner_multi(
            self, X.reshape(B, L, n)).reshape(B, L * n)


def _coupling_triples(A: Stencil9):
    """(..., L, 3, n) stacked [sub, diag, sup] lower / upper coupling rows
    of a Stencil9: lower = (csw, cs, cse), upper = (cnw, cn, cne)."""
    lo = torch.stack([A.csw, A.cs, A.cse], dim=-2)
    up = torch.stack([A.cnw, A.cn, A.cne], dim=-2)
    return lo, up


def _with_hf9(A: Stencil9, b: int, G_re, G_im, *, d2_replace,
              **tables) -> SweepingPreconditioner9:
    """Factor H_F and join it with an already factored G stack; TF takes
    the rounding of the stack's storage type."""
    HF = fd_stencil.extract_hf_stencil9(A, b)
    TF = _schur_t_stack9(HF)
    if G_re.dtype != TF.real.dtype:
        TF = torch.complex(TF.real.to(G_re.dtype).to(TF.real.dtype),
                           TF.imag.to(G_re.dtype).to(TF.real.dtype))
    hf_l, hf_u = _coupling_triples(HF)
    a_l, a_u = _coupling_triples(A)
    return SweepingPreconditioner9(
        G_re=G_re, G_im=G_im, TF=TF, hf_l=hf_l, hf_u=hf_u, a_l=a_l, a_u=a_u,
        b=b, d2_replace=d2_replace, **tables)


@torch.no_grad()
def factor_samples9_assembling(n, b, const, eta, omega, h, c_full, *, gamma,
                               pos, g_dtype,
                               setup_chunk: int = DEFAULT_SETUP_CHUNK,
                               fidelity: str = "corrected",
                               complex_dtype=None):
    """Chunked ASSEMBLE-THEN-FACTOR of the sampled 9-point subgrid family:
    one loop over chunks of the sample rows `b + pos` that assembles a
    chunk's subgrids (`fd.stencil.build_hm_stencils9(rows=...)`) and factors
    them at once into the sample planes (Ms, n, ld) at `g_dtype`, so the
    nine-field family exists one chunk at a time.  At the widths this
    scheme needs (b about n/14) even the SAMPLED family is large: 0.75 GB
    at n = 1023, b = 74, stride 7, and 5.2 GB at n = 2047, b = 147."""
    cd = complex_dtype or c_full.dtype
    dev = c_full.device
    rows = b + torch.as_tensor(pos, device=dev)
    chunk = _clamped_chunk(setup_chunk, n)
    G_re = torch.zeros((rows.shape[0], n, g_ld(n)), dtype=g_dtype, device=dev)
    G_im = torch.zeros_like(G_re)
    for start in range(0, rows.shape[0], chunk):
        hm_c = fd_stencil.build_hm_stencils9(
            n, b, const, eta, omega, h, c_full, gamma=gamma,
            fidelity=fidelity, complex_dtype=cd,
            rows=rows[start:start + chunk])
        T = _schur_corner_inverse9(hm_c)
        del hm_c
        G_re[start:start + chunk, :, :n] = T.real
        G_im[start:start + chunk, :, :n] = T.imag
        del T
    return G_re, G_im


@torch.no_grad()
def preconditioner_from_samples9(A: Stencil9, b: int, G_re, G_im, *,
                                 g_stride: int, d2_replace: bool = True
                                 ) -> SweepingPreconditioner9:
    """Build the 9-point sweeping preconditioner from an ALREADY-FACTORED
    stride-compressed sample stack (planes (Ms, n, ld), for example the
    omega-lerp of two anchor frequencies' stacks, `driver.run_multisolve`)
    plus the 9-point operator at the target frequency: only H_F is factored
    here.  The omega-lerp does not depend on the stencil: G is still a stack
    of dense corner inverses, as smooth in omega as in m."""
    M = A.cc.shape[0] - b
    return _with_hf9(A, b, G_re, G_im, d2_replace=d2_replace,
                     **_g_tables(M, g_stride, G_re.device))


@torch.no_grad()
def setup_preconditioner9(A: Stencil9, hm: Stencil9, b: int, *,
                          d2_replace: bool = True,
                          setup_chunk: int = DEFAULT_SETUP_CHUNK,
                          g_dtype=None,
                          factor_stride: int = 1,
                          hm_sampled: bool = False,
                          g_compress: bool = False,
                          device="cuda") -> SweepingPreconditioner9:
    """Factor the 9-point moving-PML preconditioner: H_F block-Thomas and
    the batched corner inverses of the 9-point subgrid family: the 5-point
    `setup_preconditioner` with the tridiagonal-coupling Schur recursion
    plugged into the shared chunk/stride machinery.

    `hm_sampled=True` declares that `hm` holds ONLY the subgrids at
    `sample_positions(M, factor_stride)` (assembled through
    `build_hm_stencils9(rows=...)`); the samples are factored and
    lerp-expanded to the dense stack, or kept as they are with
    `g_compress`.

    `g_compress=True` (requires factor_stride > 1) stores ONLY the sampled
    corner inverses plus per-step lerp tables, the contract of the 5-point
    `setup_preconditioner(g_compress=True)`.  The 9-point scheme needs
    b about n/14, so its dense stack grows faster with n than the 5-point
    path's.
    """
    dev = resolve_device(device)
    if A.device.type != dev.type or hm.device.type != dev.type:
        raise ValueError(f"A is on {A.device}, hm on {hm.device}, but "
                         f"device={device!r}")
    M = A.cc.shape[0] - b
    wf = hm.cc.real.dtype
    g_dtype = g_dtype or wf
    factor = functools.partial(factor_corner_inverses,
                               setup_chunk=setup_chunk,
                               corner_fn=_schur_corner_inverse9)
    tables = {}
    if g_compress and (factor_stride <= 1 or M <= factor_stride):
        raise ValueError("g_compress requires factor_stride > 1 (and "
                         "M > stride): the compressed layout stores the "
                         "strided samples")
    if hm_sampled and factor_stride <= 1:
        raise ValueError("hm_sampled requires factor_stride > 1")
    if g_compress:
        if not hm_sampled:
            ks = torch.as_tensor(sample_positions(M, factor_stride),
                                 device=hm.cc.device)
            hm = hm.map(lambda f: f[ks])
        G_re, G_im = factor(hm, g_dtype=g_dtype)
        tables = _g_tables(M, factor_stride, G_re.device)
    elif hm_sampled:
        G_re, G_im = expand_strided_samples(
            *factor(hm, g_dtype=wf), M=M, stride=factor_stride,
            g_dtype=g_dtype, setup_chunk=setup_chunk)
    else:
        G_re, G_im = factor(hm, g_dtype=g_dtype, stride=factor_stride)
    return _with_hf9(A, b, G_re, G_im, d2_replace=d2_replace, **tables)


@torch.no_grad()
def setup_preconditioner9_assembling(A: Stencil9, b: int, const, eta, omega,
                                     h, c_full, *, gamma, factor_stride: int,
                                     g_dtype=None, g_compress: bool = False,
                                     d2_replace: bool = True,
                                     setup_chunk: int = DEFAULT_SETUP_CHUNK,
                                     fidelity: str = "corrected"
                                     ) -> SweepingPreconditioner9:
    """The SAMPLED setup (factor_stride > 1) without a stored subgrid
    family: `factor_samples9_assembling` builds and factors the sample
    subgrids chunk by chunk; the samples are then kept (`g_compress`) or
    lerp-expanded to the dense stack, and H_F is factored from A.  Gives
    what `setup_preconditioner9(hm_sampled=True)` gives for the same
    samples."""
    n = A.cc.shape[-1]
    M = A.cc.shape[0] - b
    if factor_stride <= 1 or M <= factor_stride:
        raise ValueError("the sampled setup requires factor_stride > 1 on "
                         "more than factor_stride sweep rows")
    wf = A.cc.real.dtype
    g_dtype = g_dtype or wf
    G_re, G_im = factor_samples9_assembling(
        n, b, const, eta, omega, h, c_full, gamma=gamma,
        pos=sample_positions(M, factor_stride),
        g_dtype=g_dtype if g_compress else wf, setup_chunk=setup_chunk,
        fidelity=fidelity, complex_dtype=A.dtype)
    if g_compress:
        return preconditioner_from_samples9(A, b, G_re, G_im,
                                            g_stride=factor_stride,
                                            d2_replace=d2_replace)
    G_re, G_im = expand_strided_samples(G_re, G_im, M=M, stride=factor_stride,
                                        g_dtype=g_dtype,
                                        setup_chunk=setup_chunk)
    return _with_hf9(A, b, G_re, G_im, d2_replace=d2_replace)
