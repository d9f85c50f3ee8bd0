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
import functools

import numpy as np
import torch

from .._device import resolve_device
from ..core.sparse import Stencil5
from ..fd import stencil as fd_stencil
from ..ops.dense import batched_inverse
from ..ops.kernels.sweep import g_ld, plain_sweep, sweep

#: Complex-word budget for the batched-inverse setup workspace: at most
#: `budget // n^2` subgrids go into one batched inverse (but at least 16).
#: Measured on an H100 80GB (700 W) with scripts/measure_setup_chunk.py at
#: n = 1023: one 1023^2 complex64 inverse costs 5.4 ms in batches of 4,
#: 1.3 ms at 30, about 0.9 ms at 61 and 0.65-0.95 ms from 100 to 292, flat
#: within the run-to-run spread; the workspace peaks at about 42 bytes per
#: complex word of the batch.  1.6e8 words lets all 146 samples of the
#: n = 1023, stride-7 setup through in ONE batch (6.1 GB of workspace), which
#: gave the shortest init stage of the whole solve (1.4-1.6 s, against
#: 1.6-1.8 s at chunk 128, 1.9 s at 61 and 2.4-2.7 s at 30), and still
#: bounds the workspace near 6.7 GB for any larger grid.
SETUP_WORKSPACE_WORDS = int(1.6e8)

#: Default upper bound on the subgrids per batched inverse, above the clamp
#: that the budget gives at n = 1023 (152).
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


def _schur_step(T_prev, H: Stencil5, l: int):
    """T_l = (H_ll - diag(cs_l) T_{l-1} diag(cn_{l-1}))^{-1}.  The diagonal
    couplings turn the Schur update into a row/column scaling.  Builds S in
    a fresh buffer (T_prev may be a stored result)."""
    S = T_prev * (-H.cs[..., l, :, None])
    S.mul_(H.cn[..., l - 1, None, :])
    _add_tridiag_(S, H.cw[..., l, :], H.cc[..., l, :], H.ce[..., l, :])
    return batched_inverse(S)


def _schur_t_stack(H: Stencil5):
    """Layer Schur-complement inverses T_l = S_l^{-1}, l = 0..L-1, for a
    block-tridiagonal Stencil5 with fields (..., L, n).

    S_0 = H_00;  S_l = H_ll - diag(cs_l) @ T_{l-1} @ diag(cn_{l-1}).
    Returns T of shape (..., L, n, n).
    """
    L = H.cc.shape[-2]
    Ts = [batched_inverse(
        _dense_tridiag(H.cw[..., 0, :], H.cc[..., 0, :], H.ce[..., 0, :]))]
    for l in range(1, L):
        Ts.append(_schur_step(Ts[-1], H, l))
    return torch.stack(Ts, dim=-3)


def _schur_corner_inverse(H: Stencil5):
    """T_{L-1} = S_{L-1}^{-1} only (the subgrid corner inverse G_m), without
    stacking the intermediate T_l: peak memory a few (batch, n, n)."""
    L = H.cc.shape[-2]
    T = batched_inverse(
        _dense_tridiag(H.cw[..., 0, :], H.cc[..., 0, :], H.ce[..., 0, :]))
    for l in range(1, L):
        T = _schur_step(T, H, l)
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
    # a few (chunk, n, n) complex buffers live inside the batched inverse,
    # so the chunk scales down with the grid, but never below 16 matrices
    # per call (or 4 if the caller asks for less)
    return max(4, min(setup_chunk, max(16, SETUP_WORKSPACE_WORDS // (n * n))))


def factor_corner_inverses(hm: Stencil5, *, g_dtype,
                           setup_chunk: int = DEFAULT_SETUP_CHUNK,
                           stride: int = 1):
    """Factor a batched subgrid family (Stencil5 fields (M, b, n)) into its
    corner-inverse stack: the pair of real planes (G_re, G_im), each
    (M, n, ld) with ld = g_ld(n), pad columns zero, stored as `g_dtype`.

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
    if stride > 1 and M > stride:
        return _factor_strided(hm, g_dtype=g_dtype, setup_chunk=setup_chunk,
                               stride=stride)
    chunk = _clamped_chunk(setup_chunk, n)
    ld = g_ld(n)
    dev = hm.cc.device
    G_re = torch.zeros((M, n, ld), dtype=g_dtype, device=dev)
    G_im = torch.zeros((M, n, ld), dtype=g_dtype, device=dev)
    for start in range(0, M, chunk):
        stop = min(start + chunk, M)
        T = _schur_corner_inverse(hm.map(lambda f: f[start:stop]))
        G_re[start:stop, :, :n] = T.real
        G_im[start:stop, :, :n] = T.imag
        del T
    return G_re, G_im


def _factor_strided(hm: Stencil5, *, g_dtype, setup_chunk: int, stride: int):
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
                                          setup_chunk=setup_chunk)
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


def _block_thomas_solve(T, cs, cn, rhs):
    """Solve the block-tridiagonal system given its Schur-inverse stack.

    T: (L, n, n); cs/cn: (L, n) diagonal couplings; rhs: (L, n).  Forward
    eliminate, then combined diagonal+backward substitution: exact for
    block-tridiagonal systems.
    """
    L = T.shape[0]
    y = torch.empty_like(rhs)
    y[0] = rhs[0]
    for l in range(1, L):
        y[l] = rhs[l] - cs[l] * (T[l - 1] @ y[l - 1])
    u = torch.empty_like(rhs)
    u[L - 1] = T[L - 1] @ y[L - 1]
    for l in range(L - 2, -1, -1):
        u[l] = T[l] @ (y[l] - cn[l] * u[l + 1])
    return u


def _block_thomas_solve_multi(T, cs, cn, rhs):
    """`_block_thomas_solve` for a batch: rhs (B, L, n) -> (B, L, n).  Every
    layer step is one (n, n) @ (n, B) product for the whole batch."""
    L = T.shape[0]
    y = torch.empty_like(rhs)
    y[:, 0] = rhs[:, 0]
    for l in range(1, L):
        y[:, l] = rhs[:, l] - cs[l] * (T[l - 1] @ y[:, l - 1].T).T
    u = torch.empty_like(rhs)
    u[:, L - 1] = (T[L - 1] @ y[:, L - 1].T).T
    for l in range(L - 2, -1, -1):
        u[:, l] = (T[l] @ (y[:, l] - cn[l] * u[:, l + 1]).T).T
    return u


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
        if bool(self.g_stride) != (self.g_lo is not None) \
                or (self.g_lo is None) != (self.g_w is None):
            raise ValueError("g_stride > 0 goes with both lerp tables, "
                             "g_stride == 0 with neither")
        if self.g_stride:
            # the sweep kernel reads panels g_lo and g_lo + 1 unchecked
            lo_min, lo_max = self.g_lo.min().item(), self.g_lo.max().item()
            if lo_min < 0 or lo_max > self.G_re.shape[0] - 2:
                raise ValueError(
                    f"g_lo runs over {lo_min}..{lo_max}; a stack of "
                    f"{self.G_re.shape[0]} samples takes 0.."
                    f"{self.G_re.shape[0] - 2}")

    @property
    def grid_shape(self):
        return tuple(self.a_cs.shape)

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
    g_w, g_lo = compress_tables(M, g_stride)
    dev = G_re.device
    return _with_hf(A, b, G_re, G_im, hf_full_coupling=hf_full_coupling,
                    d2_replace=d2_replace,
                    g_w=torch.from_numpy(g_w).to(dev),
                    g_lo=torch.from_numpy(g_lo).to(dev), g_stride=g_stride)


@torch.no_grad()
def apply_preconditioner(P: SweepingPreconditioner, f: torch.Tensor,
                         impl: str = "auto") -> torch.Tensor:
    """Algorithm 2.4 analog: one sweep solve u ~= A^{-1} f.

    f has grid shape (L, n); returns the same shape and leaves f untouched
    (GMRES reuses its Krylov vectors).  The three passes of the algorithm
    (forward / diagonal / backward) are fused into two: the diagonal step
    folds into the backward sweep as
        u_j = G_j (u_j^{fwd} - cn_j * u_{j+1})               (corrected)
        u_j = u_j^{fwd} - G_j (u_j^{fwd} + cn_j * u_{j+1})   (as-shipped D2)
    so each application streams the G stack through device memory twice
    instead of three times.

    `impl`: "auto" runs the two sweeps through `ops.kernels.sweep.sweep`
    (the CUDA kernel for tensors on the card, the plain loop on the CPU);
    "plain" forces the plain loop, which is what the kernel is held against.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    run = functools.partial(sweep if impl == "auto" else plain_sweep,
                            g_lo=P.g_lo, g_w=P.g_w)
    b = P.b
    L, n = P.grid_shape
    M_total = L - b                # number of sweep rows
    u = f.clone()

    # H_F solve + first correction: u_b -= A_{b+1,F} T_F u_F
    TFuF = _block_thomas_solve(P.TF, P.hf_cs, P.hf_cn, u[:b])
    u[b] -= P.a_cs[b] * TFuF[b - 1]

    cn_top_zeroed = torch.cat(
        [P.a_cn[b:-1], torch.zeros_like(P.a_cn[-1:])], dim=0)

    # forward sweep j = b+1..L-1: u_j -= cs_j * (G_{j-1} u_{j-1}); the full
    # stack is passed with S = M-1 steps (slicing G would copy it)
    if M_total > 1:
        u[b + 1:] = run(P.G_re, P.G_im, u[b + 1:], P.a_cs[b + 1:], u[b],
                        mode="fwd")
    # fused diagonal + backward sweep, j = L-1..b; the cn_{L-1} term is
    # absent for the top row (zeroed coupling, zero carry)
    u_bwd = run(P.G_re, P.G_im, u[b:], cn_top_zeroed, torch.zeros_like(u[-1]),
                mode="bwd" if P.d2_replace else "bwd_sub")

    # F-block closure: u_F = T_F u_F - T_F (A_{F,b+1} u_b)
    rhs = torch.zeros_like(TFuF)
    rhs[b - 1] = P.a_cn[b - 1] * u_bwd[0]
    uF = TFuF - _block_thomas_solve(P.TF, P.hf_cs, P.hf_cn, rhs)
    return torch.cat([uF, u_bwd], dim=0)


@torch.no_grad()
def apply_preconditioner_multi(P: SweepingPreconditioner, F: torch.Tensor,
                               impl: str = "auto") -> torch.Tensor:
    """Batched-RHS apply: F of shape (B, L, n) -> (B, L, n), F untouched.

    The whole batch rides ONE stream of the G stack per sweep (the sweep
    kernel multiplies each loaded piece of G into every right-hand side), so
    B solves cost about one solve of device-memory traffic; the block-Thomas
    solves become (n, n) @ (n, B) products.  `impl` as in
    `apply_preconditioner`.
    """
    if impl not in ("auto", "plain"):
        raise ValueError(f"unknown impl {impl!r}")
    run = functools.partial(sweep if impl == "auto" else plain_sweep,
                            g_lo=P.g_lo, g_w=P.g_w)
    b = P.b
    L, n = P.grid_shape
    M_total = L - b
    # the sweeps take (S, B, n): steps outermost
    to_sbn = lambda x: x.transpose(0, 1).contiguous()
    u = F.clone()

    TFuF = _block_thomas_solve_multi(P.TF, P.hf_cs, P.hf_cn, u[:, :b])
    u[:, b] -= P.a_cs[b] * TFuF[:, b - 1]

    cn_top_zeroed = torch.cat(
        [P.a_cn[b:-1], torch.zeros_like(P.a_cn[-1:])], dim=0)

    if M_total > 1:
        u_fwd = run(P.G_re, P.G_im, to_sbn(u[:, b + 1:]), P.a_cs[b + 1:],
                    u[:, b].contiguous(), mode="fwd")
        u[:, b + 1:] = u_fwd.transpose(0, 1)
    u_bwd = run(P.G_re, P.G_im, to_sbn(u[:, b:]), cn_top_zeroed,
                torch.zeros_like(u[:, -1]),
                mode="bwd" if P.d2_replace else "bwd_sub").transpose(0, 1)

    rhs = torch.zeros_like(TFuF)
    rhs[:, b - 1] = P.a_cn[b - 1] * u_bwd[:, 0]
    uF = TFuF - _block_thomas_solve_multi(P.TF, P.hf_cs, P.hf_cn, rhs)
    return torch.cat([uF, u_bwd], dim=1)
