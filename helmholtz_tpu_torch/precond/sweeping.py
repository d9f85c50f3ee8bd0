"""Moving-PML sweeping preconditioner (Engquist-Ying Algorithms 2.3/2.4).

The sweep only ever needs

    T~_m u  =  (H_m^{-1} [0; ...; 0; u])[last n entries]
            =  G_m @ u,        G_m := (H_m^{-1})[b-th block, b-th block],

i.e. each subgrid solve *is* a dense n x n matvec with the corner block of
H_m^{-1}.  Since H_m is block-tridiagonal in its b layer-blocks (tridiagonal
diagonal blocks, diagonal couplings), G_m = S_b^{-1} where S_l is the
layer-Schur recursion S_l = H_ll - C_l S_{l-1}^{-1} C'_{l-1}.  Setup is
therefore b dense n x n inversions per m, batched over many m at once, and
each sweep step is one dense matvec.

H_F (the leading bn x bn block) must be solved against full-length vectors,
so it keeps a block-Thomas factorization: the stack T_l = S_l^{-1} of layer
Schur-complement inverses, applied with forward/diagonal/backward passes.

Fidelity: the *corrected* algorithm is the default and reproduces the
paper's 2-3 iteration convergence.  `d2_replace=False` reproduces the
as-shipped subtract-instead-of-replace diagonal step; the as-shipped
block-diagonal H_F is selected at setup via `hf_full_coupling=False`.

State layout of the port: everything is a native complex tensor except the
G stack, which is two real planes (re, im) of shape (M, n, ld) because its
storage type may be bfloat16, for which PyTorch has no complex type.  The
row pitch ld = `ops.kernels.sweep.g_ld(n)` is the sweep kernel's alignment
contract; the pad columns are zero.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device
from ..core.sparse import Stencil5
from ..fd import stencil as fd_stencil
from ..ops.dense import batched_inverse, batched_inverse_sym
from ..ops.kernels.sweep import g_ld, plain_sweep, sweep

#: Complex-word budget for the batched-inverse setup workspace: at most
#: `budget // n^2` subgrids go into one batched inverse (but at least 16).
#: On the card the inverse is the blocked Gauss-Jordan (`ops.dense`), whose
#: peak is the padded work matrix (n to 1024 at n = 1023), the panel row and
#: column (rowk, colk: nb x 1024 each), the new panel column, the Schur
#: matrix being inverted and the previous layer's inverse: about 3.8
#: complex words per word of the batch, and measured at 30.6 bytes per
#: complex word on an H100 80GB (700 W) by scripts/measure_setup_chunk.py at
#: n = 1023 for every chunk from 4 to 300 (pivoted LU, which the budget was
#: first sized for: 40.1).  A 1023^2 inverse costs 1.3 ms in batches of 4,
#: 0.51-0.53 ms at 16-30 and 0.35-0.37 ms from 61 to 300 (LU: 6.0, 1.4-2.4
#: and 0.70-1.01 ms).  2.1e8 words keeps the old bound of about 6.4 GB of
#: workspace and lets all 146 samples of the n = 1023, stride-7 setup
#: through in ONE batch.  The symmetric route that the 5-point families
#: take holds less (no colk, no new panel column), so the same budget
#: bounds it.
SETUP_WORKSPACE_WORDS = int(2.1e8)

#: Default upper bound on the subgrids per batched inverse, above the clamp
#: that the budget gives at n = 1023 (200).
DEFAULT_SETUP_CHUNK = 256

#: Real-word budget for the temporaries of one lerp-expansion chunk; a
#: memory bound only.
EXPAND_WORKSPACE_WORDS = int(9.0e7)


def _dense_tridiag(cw, cc, ce):
    """Dense (..., n, n) from per-layer tridiagonal fields (..., n).

    cw is the sub-diagonal coupling (masked zero at i=0), ce the super
    (masked at i=n-1), cc the main diagonal.
    """
    n = cc.shape[-1]
    out = torch.zeros((*cc.shape[:-1], n, n), dtype=cc.dtype,
                      device=cc.device)
    _add_tridiag_(out, cw, cc, ce)
    return out


def _add_tridiag_(X, cw, cc, ce):
    """X += tridiag(cw, cc, ce), in place, through diagonal views."""
    X.diagonal(dim1=-2, dim2=-1).add_(cc)
    X.diagonal(offset=-1, dim1=-2, dim2=-1).add_(cw[..., 1:])
    X.diagonal(offset=1, dim1=-2, dim2=-1).add_(ce[..., :-1])
    return X


def _schur_step(T_prev, H: Stencil5, l: int, inverse):
    """T_l = (H_ll - diag(cs_l) T_{l-1} diag(cn_{l-1}))^{-1}.  The diagonal
    couplings turn the Schur update into a row/column scaling.  Builds S in
    a fresh buffer (T_prev may be a stored result) and inverts it with
    `inverse`, the family's route (`_schur_inverse`)."""
    S = T_prev * (-H.cs[..., l, :, None])
    S.mul_(H.cn[..., l - 1, None, :])
    _add_tridiag_(S, H.cw[..., l, :], H.cc[..., l, :], H.ce[..., l, :])
    return inverse(S)


def _schur_inverse(H: Stencil5):
    """The batched inverse for the layer Schur blocks of the family H:
    `batched_inverse_sym` when H is complex-symmetric as stored, else
    `batched_inverse`.

    The 5-point operator is complex-symmetric: cw[i] = ce[i-1] (both s1 at
    the same midpoint over s2) and cs_l = cn_{l-1}; then S_0 = H_00, every
    T_l = S_l^{-1} and every S_l = H_ll - diag(cs_l) T_{l-1} diag(cn_{l-1})
    are symmetric, S_l to rounding (T_ij (-cs_i) cn_j and T_ji (-cs_j) cn_i
    multiply in another order).  The couplings are compared exactly, once
    for the whole family (one host sync); a family built with other
    couplings takes the general route."""
    sym = (torch.equal(H.cw[..., 1:], H.ce[..., :-1])
           and torch.equal(H.cs[..., 1:, :], H.cn[..., :-1, :]))
    return batched_inverse_sym if sym else batched_inverse


def _schur_t_stack(H: Stencil5):
    """Layer Schur-complement inverses T_l = S_l^{-1}, l = 0..L-1, for a
    block-tridiagonal Stencil5 with fields (..., L, n).

    S_0 = H_00;  S_l = H_ll - diag(cs_l) @ T_{l-1} @ diag(cn_{l-1}).
    Returns T of shape (..., L, n, n).
    """
    L = H.cc.shape[-2]
    inverse = _schur_inverse(H)
    Ts = [inverse(
        _dense_tridiag(H.cw[..., 0, :], H.cc[..., 0, :], H.ce[..., 0, :]))]
    for l in range(1, L):
        Ts.append(_schur_step(Ts[-1], H, l, inverse))
    return torch.stack(Ts, dim=-3)


def _schur_corner_inverse(H: Stencil5):
    """T_{L-1} = S_{L-1}^{-1} only (the subgrid corner inverse G_m), without
    stacking the intermediate T_l: peak memory a few (batch, n, n)."""
    L = H.cc.shape[-2]
    inverse = _schur_inverse(H)
    T = inverse(
        _dense_tridiag(H.cw[..., 0, :], H.cc[..., 0, :], H.ce[..., 0, :]))
    for l in range(1, L):
        T = _schur_step(T, H, l, inverse)
    return T


def sample_positions(M: int, R: int) -> np.ndarray:
    """Sweep-space sample positions for stride-R factorization: the
    multiples of R (anchored at k = 0) with the endpoint M-1 always a
    sample."""
    Ms = (M - 1) // R + 2
    return np.minimum(np.arange(Ms) * R, M - 1)


def band_sample_window(M: int, R: int, k_first: int, k_last: int):
    """Inclusive sample index window (s0, s1) bracketing sweep rows
    k_first..k_last of a stride-R compressed stack whose samples are
    `sample_positions(M, R)`: every row k in the band has its bracketing
    pair (lo, lo+1) inside [s0, s1]."""
    Ms = (M - 1) // R + 2
    s0 = min(k_first // R, Ms - 2)
    s1 = min(k_last // R, Ms - 2) + 1
    return s0, s1


def compress_tables(M: int, R: int):
    """Per-row (g_w, g_lo) lerp tables, as numpy arrays, for a stride-R
    compressed G stack: row k applies
    g_w[k,0] * S[g_lo[k]] + g_w[k,1] * S[g_lo[k]+1] over the
    `sample_positions(M, R)` sample stack.  Static given (M, R): anchor
    stacks factored at DIFFERENT frequencies share the same tables, which is
    what makes the omega-lerp of sample panels well-defined
    (driver.run_multisolve frequency amortization).  The weights are
    float32 whatever the working precision, as in the reference package."""
    pos = sample_positions(M, R)
    Ms = pos.shape[0]
    k = np.arange(M)
    lo = np.minimum(k // R, Ms - 2)
    denom = np.maximum(pos[lo + 1] - pos[lo], 1)
    t = (k - pos[lo]) / denom
    g_w = np.stack([1.0 - t, t], axis=1).astype(np.float32)
    return g_w, lo.astype(np.int32)


def _clamped_chunk(setup_chunk: int, n: int) -> int:
    # about four (chunk, n, n) complex buffers live inside the inverse,
    # so the chunk scales down with the grid, but never below 16 matrices
    # per call (or 4 if the caller asks for less)
    return max(4, min(setup_chunk, max(16, SETUP_WORKSPACE_WORDS // (n * n))))


def factor_corner_inverses(hm, *, g_dtype,
                           setup_chunk: int = DEFAULT_SETUP_CHUNK,
                           stride: int = 1, corner_fn=None):
    """Factor a batched subgrid family (stencil fields (M, b, n)) into its
    corner-inverse stack: the pair of real planes (G_re, G_im), each
    (M, n, ld) with ld = g_ld(n), pad columns zero, stored as `g_dtype`.

    `corner_fn` maps a chunk of the family to its (chunk, n, n) corner
    inverses; the default is the 5-point recursion `_schur_corner_inverse`,
    and the 9-point scheme passes its own (`precond.sweeping9`).

    The planes are allocated once and filled chunk by chunk IN PLACE: a
    stacked result would transiently double the multi-GB stack.

    `stride` > 1 factors only every stride-th subgrid and linearly
    interpolates the corner inverses between samples, dividing the setup
    flops by ~stride.  Valid because G_m is a SMOOTH function of m:
    consecutive subgrids share the whole moved-PML structure and differ only
    by a one-row shift of the velocity window, so for velocity fields smooth
    on the scale of stride rows the interpolation error is
    O((stride*h / feature_scale)^2), far below the bf16 storage rounding
    that already leaves GMRES iteration counts unchanged.  Exact (any
    stride) for row-invariant media.  The endpoint m = M-1 is always a
    sample.  Iteration-count parity against stride = 1 is the guard.

    Peak memory is the final G plus a few chunk * n^2 complex words of
    batched-inverse workspace; the strided path additionally holds the
    sample stack at working precision while interpolating.
    """
    M, _, n = hm.cc.shape
    corner_fn = corner_fn or _schur_corner_inverse
    if stride > 1 and M > stride:
        return _factor_strided(hm, g_dtype=g_dtype, setup_chunk=setup_chunk,
                               stride=stride, corner_fn=corner_fn)
    chunk = _clamped_chunk(setup_chunk, n)
    ld = g_ld(n)
    dev = hm.cc.device
    G_re = torch.zeros((M, n, ld), dtype=g_dtype, device=dev)
    G_im = torch.zeros((M, n, ld), dtype=g_dtype, device=dev)
    for start in range(0, M, chunk):
        stop = min(start + chunk, M)
        T = corner_fn(hm.map(lambda f: f[start:stop]))
        G_re[start:stop, :, :n] = T.real
        G_im[start:stop, :, :n] = T.imag
        del T
    return G_re, G_im


def _factor_strided(hm, *, g_dtype, setup_chunk: int, stride: int,
                    corner_fn):
    """Strided factorization: factor every stride-th subgrid exactly, lerp
    the corner inverses in between."""
    M = hm.cc.shape[0]
    wf = hm.cc.real.dtype                      # working float
    # a duplicated endpoint sample (stride | M-1) costs one redundant
    # factorization and lerps with weight zero
    ks = torch.as_tensor(sample_positions(M, stride), device=hm.cc.device)
    hm_s = hm.map(lambda f: f[ks])
    # samples at working precision, already at the padded pitch (zero pads
    # lerp to zero)
    Ts_re, Ts_im = factor_corner_inverses(hm_s, g_dtype=wf,
                                          setup_chunk=setup_chunk,
                                          corner_fn=corner_fn)
    return expand_strided_samples(Ts_re, Ts_im, M=M, stride=stride,
                                  g_dtype=g_dtype, setup_chunk=setup_chunk)


def expand_strided_samples(Ts_re, Ts_im, *, M: int, stride: int, g_dtype,
                           setup_chunk: int = DEFAULT_SETUP_CHUNK):
    """Chunked lerp-expansion of a stride-sampled corner-inverse stack
    (Ms, n, ld; positions `sample_positions(M, stride)`) to the dense
    (M, n, ld) planes at `g_dtype`.  The lerp weights and the interpolation
    stay in the working float; G is rounded only when stored."""
    wf = Ts_re.dtype
    Ms_have, n, ld = Ts_re.shape
    dev = Ts_re.device
    pos = sample_positions(M, stride)
    Ms = pos.shape[0]
    if Ms_have != Ms:
        raise ValueError(
            f"sample stack has {Ms_have} entries; "
            f"sample_positions({M}, {stride}) defines {Ms}: the stack was "
            "not assembled at the shared strided layout")
    ks = torch.as_tensor(pos, device=dev)
    wchunk = max(4, min(setup_chunk, EXPAND_WORKSPACE_WORDS // (n * ld)))
    G_re = torch.zeros((M, n, ld), dtype=g_dtype, device=dev)
    G_im = torch.zeros((M, n, ld), dtype=g_dtype, device=dev)
    for start in range(0, M, wchunk):
        stop = min(start + wchunk, M)
        m = torch.arange(start, stop, device=dev)
        seg = torch.clamp(m // stride, max=Ms - 2)
        lo, hi = ks[seg], ks[seg + 1]
        # duplicated endpoint sample (stride | M-1): hi == lo there, and
        # m == lo makes the guarded weight exactly 0 (pure lo sample)
        w = ((m - lo).to(wf)
             / torch.clamp(hi - lo, min=1).to(wf))[:, None, None]
        for T, G in ((Ts_re, G_re), (Ts_im, G_im)):
            G[start:stop] = (1.0 - w) * T[seg] + w * T[seg + 1]
    return G_re, G_im


def couple(c, v, minus=None, out=None):
    """The coupling rows c applied to the rows v (..., n): c (n,) is a
    diagonal (the 5-point scheme), c (3, n) the [sub, diag, sup] rows of a
    tridiagonal (the 9-point scheme), (c v)_i = sub_i v_{i-1} + diag_i v_i
    + sup_i v_{i+1}; sub[0] and sup[-1] are not read.  The rank tells the
    two apart, as in `ops.kernels.sweep.sweep`.  With `minus`, returns
    minus - c v instead, written into `out` when given (for a tridiagonal,
    three fused multiply-adds)."""
    if minus is None:
        if c.ndim == 1:
            return c * v
        y, sign = c[1] * v, 1
    elif c.ndim == 1:
        return torch.sub(minus, c * v, out=out)
    else:
        y, sign = torch.addcmul(minus, c[1], v, value=-1, out=out), -1
    y[..., 1:].addcmul_(c[0, 1:], v[..., :-1], value=sign)
    y[..., :-1].addcmul_(c[2, :-1], v[..., 1:], value=sign)
    return y


def block_thomas_solve(T, c_lo, c_up, rhs):
    """Solve a block-tridiagonal system given its Schur-inverse stack.

    T: (L, n, n); c_lo / c_up: the lower / upper coupling rows, (L, n) or
    (L, 3, n) (`couple`); rhs: (L, B, n), rows outermost, -> (L, B, n).
    Forward eliminate, then combined diagonal+backward substitution: exact
    for block-tridiagonal systems.  Every layer step is one product with
    T_l for the whole batch (a matrix-vector product for a batch of one,
    else (n, n) @ (n, B)) and the coupling's multiply-adds: the loop is
    bound by the host's launches, so it makes few.
    """
    L = T.shape[0]
    if rhs.shape[1] == 1:
        mat = lambda l, v: torch.mv(T[l], v[0])[None]
    else:
        mat = lambda l, v: (T[l] @ v.T).T
    y = torch.empty_like(rhs)
    y[0] = rhs[0]
    for l in range(1, L):
        couple(c_lo[l], mat(l - 1, y[l - 1]), minus=rhs[l], out=y[l])
    u = torch.empty_like(rhs)
    u[L - 1] = mat(L - 1, y[L - 1])
    tmp = torch.empty_like(rhs[0])
    for l in range(L - 2, -1, -1):
        u[l] = mat(l, couple(c_up[l], u[l + 1], minus=y[l], out=tmp))
    return u


def _check_g_tables(P) -> None:
    """What a factored state (5-point or 9-point) must hold about its lerp
    tables: both or neither, and indices inside the sample stack."""
    if bool(P.g_stride) != (P.g_lo is not None) \
            or (P.g_lo is None) != (P.g_w is None):
        raise ValueError("g_stride > 0 goes with both lerp tables, "
                         "g_stride == 0 with neither")
    if P.g_stride:
        # the sweep kernel reads panels g_lo and g_lo + 1 unchecked
        lo_min, lo_max = P.g_lo.min().item(), P.g_lo.max().item()
        if lo_min < 0 or lo_max > P.G_re.shape[0] - 2:
            raise ValueError(
                f"g_lo runs over {lo_min}..{lo_max}; a stack of "
                f"{P.G_re.shape[0]} samples takes 0.."
                f"{P.G_re.shape[0] - 2}")


def _g_tables(M: int, g_stride: int, dev) -> dict:
    """The lerp-table fields of a state whose planes hold the
    `sample_positions(M, g_stride)` samples, on device `dev`."""
    g_w, g_lo = compress_tables(M, g_stride)
    return dict(g_w=torch.from_numpy(g_w).to(dev),
                g_lo=torch.from_numpy(g_lo).to(dev), g_stride=g_stride)


@dataclasses.dataclass(frozen=True)
class SweepingPreconditioner:
    """Factored state of the moving-PML sweeping preconditioner.

    G_re, G_im : (M, n, ld) real planes, M = n-b (or M = 1 for a
           row-invariant medium: one shared corner inverse).  G[k] acts on
           grid row j = b+k (0-based), i.e. the subgrid whose top layer is
           j.  This is the largest state of the system by far.
    TF   : (b, n, n) complex: block-Thomas Schur-inverse stack for H_F.
    hf_* : H_F interlayer couplings; a_*: the global operator's interlayer
           couplings (rows of A.cs / A.cn).
    g_w, g_lo, g_stride : sample-compressed G.  g_stride > 0 means the
           planes hold only the `sample_positions(n-b, g_stride)` corner
           inverses and sweep row k applies
           g_w[k,0] * G[g_lo[k]] + g_w[k,1] * G[g_lo[k]+1]
           (g_w (n-b, 2) float32, g_lo (n-b,) int32, on the planes' device).
           g_stride == 0: dense (or shared) planes, no tables.
    """

    G_re: torch.Tensor
    G_im: torch.Tensor
    TF: torch.Tensor
    hf_cs: torch.Tensor
    hf_cn: torch.Tensor
    a_cs: torch.Tensor
    a_cn: torch.Tensor
    b: int
    d2_replace: bool
    g_w: torch.Tensor | None = None
    g_lo: torch.Tensor | None = None
    g_stride: int = 0

    def __post_init__(self):
        _check_g_tables(self)

    @property
    def grid_shape(self):
        return tuple(self.a_cs.shape)

    @property
    def couplings(self):
        """(hf_lo, hf_up, a_lo, a_up) as `apply_rows` takes them."""
        return self.hf_cs, self.hf_cn, self.a_cs, self.a_cn

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """LinearOperator-style matvec on a flat (N,) vector."""
        L, n = self.grid_shape
        return apply_preconditioner(self, x.reshape(L, n)).reshape(-1)

    def apply_multi(self, X: torch.Tensor) -> torch.Tensor:
        """The same for a batch of flat vectors, (B, N) -> (B, N): the whole
        batch rides one stream of G per sweep."""
        L, n = self.grid_shape
        B = X.shape[0]
        return apply_preconditioner_multi(
            self, X.reshape(B, L, n)).reshape(B, L * n)


@torch.no_grad()
def setup_preconditioner(A: Stencil5, hm: Stencil5, b: int, *,
                         hf_full_coupling: bool = True,
                         d2_replace: bool = True,
                         setup_chunk: int = DEFAULT_SETUP_CHUNK,
                         g_dtype=None,
                         factor_stride: int = 1,
                         g_compress: bool = False,
                         device="cuda") -> SweepingPreconditioner:
    """Algorithm 2.3 analog: factor H_F and every H_m.

    `hm` is the batched subgrid family from `fd.stencil.build_hm_stencils`
    (fields (M, b, n)), on `device` like A.  The per-m Schur recursions are
    independent and run in chunks of at most `setup_chunk` subgrids.

    `g_dtype` (default: the working float) is the STORAGE type of the G
    stack.  `torch.bfloat16` halves the factor memory and the apply's
    device-memory traffic (the sweep's dominant term) at an ~8-bit-mantissa
    G; the moving-PML approximation error dominates far earlier, so
    iteration counts are unchanged at the reference scales.  The Schur
    recursion itself always runs at the working precision: only storage is
    rounded.

    `g_compress=True` (with factor_stride > 1) stores ONLY the sampled
    corner inverses plus per-step lerp weights instead of expanding the
    interpolation to the dense stack: at-rest factor memory drops
    ~factor_stride-fold, and the sweep kernel combines the two bracketing
    sample panels' products per step.  The interpolated operator is the
    same as the expanded strided stack's up to the float32 rounding of the
    weights.
    """
    dev = resolve_device(device)
    if A.device.type != dev.type or hm.device.type != dev.type:
        raise ValueError(f"A is on {A.device}, hm on {hm.device}, but "
                         f"device={device!r}")
    g_dtype = g_dtype or hm.cc.real.dtype
    M = hm.cc.shape[0]
    if g_compress and factor_stride > 1 and M > factor_stride:
        ks = torch.as_tensor(sample_positions(M, factor_stride),
                             device=hm.cc.device)
        G_re, G_im = factor_corner_inverses(hm.map(lambda f: f[ks]),
                                            g_dtype=g_dtype,
                                            setup_chunk=setup_chunk)
        return preconditioner_from_samples(
            A, b, G_re, G_im, g_stride=factor_stride,
            hf_full_coupling=hf_full_coupling, d2_replace=d2_replace)
    G_re, G_im = factor_corner_inverses(hm, g_dtype=g_dtype,
                                        setup_chunk=setup_chunk,
                                        stride=factor_stride)
    return _with_hf(A, b, G_re, G_im, hf_full_coupling=hf_full_coupling,
                    d2_replace=d2_replace)


def _with_hf(A: Stencil5, b: int, G_re, G_im, *, hf_full_coupling,
             d2_replace, **tables) -> SweepingPreconditioner:
    """Factor H_F and join it with an already factored G stack."""
    HF = fd_stencil.extract_hf_stencil(A, b, full_coupling=hf_full_coupling)
    TF = _schur_t_stack(HF)
    return SweepingPreconditioner(
        G_re=G_re, G_im=G_im, TF=TF, hf_cs=HF.cs, hf_cn=HF.cn,
        a_cs=A.cs.contiguous(), a_cn=A.cn.contiguous(), b=b,
        d2_replace=d2_replace, **tables)


@torch.no_grad()
def preconditioner_from_samples(A: Stencil5, b: int, G_re, G_im, *,
                                g_stride: int,
                                hf_full_coupling: bool = True,
                                d2_replace: bool = True
                                ) -> SweepingPreconditioner:
    """Build the full sweeping preconditioner from an ALREADY-FACTORED
    stride-compressed sample stack (planes (Ms, n, ld), for example the
    omega-lerp of two anchor frequencies' stacks, driver.run_multisolve)
    plus the operator A at the target frequency: only H_F is factored here
    (b small inversions); the O(M/stride) corner-inverse factorizations, the
    setup giant, are not re-paid."""
    M = A.cc.shape[0] - b
    return _with_hf(A, b, G_re, G_im, hf_full_coupling=hf_full_coupling,
                    d2_replace=d2_replace,
                    **_g_tables(M, g_stride, G_re.device))


def apply_rows(P, u: torch.Tensor, run) -> torch.Tensor:
    """Algorithm 2.4 analog, the one body of every apply on one card: the
    sweep solve v ~= A^{-1} u of each member of the batch u (L, B, n),
    rows outermost as the sweeps take it; v is written over u and returned.

    P is a factored state of either stencil, or the recompute state: its
    H_F stack `TF`, `b`, `d2_replace` and `couplings`, the rows (hf_lo,
    hf_up, a_lo, a_up) of either rank (`couple`).  `run(mode, rows, c,
    carry)` runs one sweep recursion (`ops.kernels.sweep.sweep`'s modes)
    over the sweep rows `rows` (S, B, n) in place and supplies G: the held
    stack (`_stack_runner`) or G re-derived chunk by chunk
    (`precond.recompute`).  The three passes of the algorithm (forward /
    diagonal / backward) are fused into two: the diagonal step folds into
    the backward sweep as
        u_j = G_j (u_j^{fwd} - U_j u_{j+1})               (corrected)
        u_j = u_j^{fwd} - G_j (u_j^{fwd} + U_j u_{j+1})   (as-shipped D2)
    so each application streams G through device memory twice instead of
    three times.
    """
    hf_lo, hf_up, a_lo, a_up = P.couplings
    b = P.b
    thomas = lambda r: block_thomas_solve(P.TF, hf_lo, hf_up, r)

    # H_F solve + first correction: u_b -= A_{b,F} T_F u_F
    TFuF = thomas(u[:b])
    u[b] -= couple(a_lo[b], TFuF[b - 1])

    # forward sweep j = b+1..L-1: u_j -= L_j (G_{j-1} u_{j-1}), carry u_b
    if u.shape[0] - b > 1:
        run("fwd", u[b + 1:], a_lo[b + 1:], u[b])
    # fused diagonal + backward sweep, j = L-1..b; the upper coupling of
    # the top row is zeroed (no layer above) and its carry is zero
    a_up_top0 = torch.cat([a_up[b:-1], torch.zeros_like(a_up[-1:])], dim=0)
    run("bwd" if P.d2_replace else "bwd_sub", u[b:], a_up_top0,
        torch.zeros_like(u[-1]))

    # F-block closure: u_F = T_F u_F - T_F (A_{F,b} u_b)
    rhs = torch.zeros_like(TFuF)
    rhs[b - 1] = couple(a_up[b - 1], u[b])
    u[:b] = TFuF - thomas(rhs)
    return u


def _stack_runner(P, impl: str):
    """`apply_rows`' sweep runner over a held G stack: `sweep` (the CUDA
    kernel for tensors on the card, the plain loop on the CPU), or under
    impl="plain" the plain loop, which is what the kernel is held against;
    the whole stack is passed with the state's lerp tables (slicing G
    would copy it)."""
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    fn = sweep if impl == "auto" else plain_sweep

    def run(mode, rows, c, carry):
        rows.copy_(fn(P.G_re, P.G_im, rows, c, carry, mode=mode,
                      g_lo=P.g_lo, g_w=P.g_w))
    return run


@torch.no_grad()
def apply_preconditioner(P, f: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """One sweep solve u ~= A^{-1} f for f of grid shape (L, n), f left
    untouched (GMRES reuses its Krylov vectors): `apply_preconditioner_multi`
    on a batch of one.  P is a `SweepingPreconditioner` or a
    `precond.sweeping9.SweepingPreconditioner9`."""
    return apply_preconditioner_multi(P, f[None], impl)[0]


@torch.no_grad()
def apply_preconditioner_multi(P, F: torch.Tensor,
                               impl: str = "auto") -> torch.Tensor:
    """Batched-RHS apply of either stencil's state: F of shape (B, L, n) ->
    (B, L, n), F untouched; `apply_rows` over the held stack.

    Over a dense G stack with diagonal coupling the whole batch rides ONE
    stream of G per sweep, in one launch of the sweep kernel whatever B
    (the wide kernel above four right-hand sides: each loaded piece of G is
    multiplied into every right-hand side of a block's slice), so B solves
    cost about one solve of device-memory traffic.  Over a sample-
    compressed stack, or with tridiagonal coupling, the launches carry at
    most four right-hand sides, and a larger batch reads G once a chunk of
    four (`ops.kernels.sweep.launch_widths`).

    `impl`: "auto" runs the two sweeps through `ops.kernels.sweep.sweep`;
    "plain" forces its plain loop (`_stack_runner`).
    """
    u = apply_rows(P, rows_outermost(F), _stack_runner(P, impl))
    return u.transpose(0, 1).contiguous()


def rows_outermost(F: torch.Tensor) -> torch.Tensor:
    """A fresh (L, B, n) copy of the batch F (B, L, n), for `apply_rows`
    to overwrite (for B = 1 the transposed view already counts as
    contiguous, so `contiguous()` would hand back F itself)."""
    return F.transpose(0, 1).clone(memory_format=torch.contiguous_format)


def apply_fixed_rhs(P: SweepingPreconditioner, f_fixed: torch.Tensor):
    """Deviation D1 of the reference code, emulated: a "preconditioner"
    that ignores its argument and returns the sweep of the fixed right-hand
    side, computed once.  For emulation and diagnosis only: it is not a
    linear operator, so no solver path takes it."""
    L, n = P.grid_shape
    u = apply_preconditioner(P, f_fixed.reshape(L, n)).reshape(-1)
    return lambda _x: u
