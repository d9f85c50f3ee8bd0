"""Recompute-G sweeping preconditioner: the factor-free point of the
store-versus-recompute frontier, ported from the JAX package's
`precond/recompute.py`.

The stored strategy (`sweeping.SweepingPreconditioner`) keeps the whole
(M, n, n) corner-inverse stack G, the largest state of the system.  This
one keeps no factor state: each application re-assembles and re-factors
the moving-PML subgrids a chunk of sweep rows at a time while the sweeps
pass through them, so the at-rest footprint is the velocity field, the H_F
block-Thomas stack and the coupling rows, O(n^2) in all.  The price is
about twice the setup's factorization work per application (each of the
two sweeps re-derives the chunks it consumes).

The apply is built from the port's kernels, not from a second copy of the
recursion:

  * chunk re-factor: `fd.stencil.build_hm_stencils_rows` for the chunk's
    rows (for factor_stride > 1 the globally anchored SAMPLE rows), then
    `sweeping._schur_corner_inverse`, whose inverses go through
    `ops.dense.batched_inverse`: on the card the blocked Gauss-Jordan with
    the Gauss-Jordan kernel (K3) at its base.  The inverses are written
    into ONE pair of real planes of (chunk or samples, n, g_ld(n)), made
    once per application and reused by every chunk of both sweeps, so only
    one chunk of G is ever live;
  * chunk sweep: `ops.kernels.sweep.sweep` (K2) on those planes, mode
    "fwd" with the last updated row of the previous chunk as its carry,
    then "bwd" ("bwd_sub" for the as-shipped diagonal step) from the top
    chunk down, with the first row of the chunk above as its carry and the
    top coupling zeroed.  For factor_stride > 1 the planes hold the chunk's
    samples and the sweep runs the kernel's lerp mode with chunk-local
    tables: the same interpolated operator as the stored strided path,
    without expanding a dense chunk;
  * H_F: `sweeping._block_thomas_solve` before and after the sweeps, as in
    the stored apply.

The JAX package factors each chunk with its matrix-fraction recursion
(`_schur_corner_inverse_fraction`, `schur_block`); the port factors it
with its own `_schur_corner_inverse`, which computes the same corner
inverses.  The TPU workarounds around the JAX module (the host-loop
reroute, `HELMHOLTZ_TPU_RECOMPUTE_CHUNK_LOOP`, the loop-style experiments)
are not ported.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Optional

import numpy as np
import torch

from ..core.sparse import Stencil5
from ..fd import stencil as fd_stencil
from ..ops.kernels.sweep import g_ld, sweep
from ..utils.profiling import annotate
from .sweeping import (_block_thomas_solve, _block_thomas_solve_multi,
                       _schur_corner_inverse, _schur_t_stack)

#: complex words of one chunk of corner inverses that the auto chunk
#: allows: max(4, min(128, AUTO_CHUNK_WORDS // n^2)) rows, as in the JAX
#: package
AUTO_CHUNK_WORDS = int(2.5e8)


@dataclasses.dataclass(frozen=True)
class RecomputeSweepingPreconditioner:
    """Factor-free preconditioner state: the frequency, the velocity field
    and the H_F factors.

    At-rest memory is O(n^2) (c_full, TF, coupling rows): no G stack.
    `chunk` sweep rows are re-factored per sweep stage; None = the auto
    chunk (`chunk_rows`).  factor_stride > 1 re-factors only the globally
    anchored samples and interpolates between them.
    """

    wave_num: float
    const: float
    alpha: float
    c_full: torch.Tensor          # (n+2, n+2) real velocity field
    TF: torch.Tensor              # (b, n, n) H_F Schur-inverse stack
    hf_cs: torch.Tensor
    hf_cn: torch.Tensor
    a_cs: torch.Tensor            # (L, n) global interlayer couplings
    a_cn: torch.Tensor
    n: int
    b: int
    fidelity: str
    chunk: Optional[int]
    d2_replace: bool
    factor_stride: int = 1

    @property
    def grid_shape(self):
        return tuple(self.a_cs.shape)

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        """LinearOperator-style matvec on a flat (N,) vector."""
        L, n = self.grid_shape
        return apply_recompute(self, x.reshape(L, n)).reshape(-1)

    def apply_multi(self, X: torch.Tensor) -> torch.Tensor:
        """The same for a batch of flat vectors, (B, N) -> (B, N): every
        chunk is re-factored once for the whole batch."""
        L, n = self.grid_shape
        B = X.shape[0]
        return apply_recompute_multi(
            self, X.reshape(B, L, n)).reshape(B, L * n)


@torch.no_grad()
def setup_recompute(n: int, b: int, wave_num, const, alpha, c_full, *,
                    A: Stencil5, fidelity: str = "corrected",
                    hf_full_coupling: bool = True, d2_replace: bool = True,
                    chunk: Optional[int] = None,
                    factor_stride: int = 1
                    ) -> RecomputeSweepingPreconditioner:
    """'Factor' the recompute preconditioner: only H_F is factored (its
    block-Thomas stack is needed against full-length vectors at every
    apply); the subgrid family is re-derived from (frequency, c_full)
    inside each application.  Everything lives on A's device."""
    HF = fd_stencil.extract_hf_stencil(A, b, full_coupling=hf_full_coupling)
    return RecomputeSweepingPreconditioner(
        wave_num=float(wave_num), const=float(const), alpha=float(alpha),
        c_full=c_full, TF=_schur_t_stack(HF), hf_cs=HF.cs, hf_cn=HF.cn,
        a_cs=A.cs.contiguous(), a_cn=A.cn.contiguous(), n=n, b=b,
        fidelity=fidelity, chunk=chunk, d2_replace=d2_replace,
        factor_stride=max(1, int(factor_stride)))


def chunk_rows(R: RecomputeSweepingPreconditioner) -> int:
    """Sweep rows re-factored at once: R.chunk, or the JAX package's auto
    chunk max(4, min(128, 2.5e8 // n^2)); at most the M = L - b rows."""
    L, n = R.grid_shape
    chunk = R.chunk or max(4, min(128, AUTO_CHUNK_WORDS // (n * n)))
    return min(chunk, L - R.b)


def sample_window(c: int, stride: int) -> int:
    """Samples that cover any c consecutive rows at the worst alignment
    (the last row's lo sample sits floor((c + stride - 2) / stride)
    strides past the first's)."""
    return (c + stride - 2) // stride + 2


@functools.lru_cache(maxsize=4096)
def chunk_tables(M: int, stride: int, k0: int, c: int):
    """The globally anchored samples of sweep rows k0..k0+c-1 and the
    chunk-local lerp tables, as numpy: (offs (S,), g_lo (c,) int32,
    g_w (c, 2) float32).  offs are the multiples of stride from
    floor(k0/stride)*stride upward, clamped to the endpoint M-1 (always a
    sample, as in the stored strided path); row k applies
    g_w[0] * sample[g_lo] + g_w[1] * sample[g_lo + 1]."""
    S = sample_window(c, stride)
    lo0 = (k0 // stride) * stride
    offs = np.minimum(lo0 + np.arange(S) * stride, M - 1)
    k = k0 + np.arange(c)
    seg = np.minimum((k - lo0) // stride, S - 2)
    lo, hi = offs[seg], offs[seg + 1]
    t = (k - lo) / np.maximum(hi - lo, 1)
    g_w = np.stack([1.0 - t, t], axis=1).astype(np.float32)
    return offs, seg.astype(np.int32), g_w


def _check_chunk_tables(g_lo: np.ndarray, S: int) -> None:
    """`sweeping._check_g_tables`'s rule for a chunk: the sweep kernel
    reads samples g_lo and g_lo + 1 unchecked."""
    if g_lo.min() < 0 or g_lo.max() > S - 2:
        raise ValueError(f"g_lo runs over {g_lo.min()}..{g_lo.max()}; a "
                         f"window of {S} samples takes 0..{S - 2}")


def _chunk_g(R: RecomputeSweepingPreconditioner, k0: int, c: int, planes):
    """Corner inverses of sweep rows k0..k0+c-1 (G_k acts on grid row
    b+k), re-assembled from the velocity field and re-factored into the
    leading panels of `planes` (re, im): (chunk or samples, n, g_ld(n)),
    pad columns zero.  Returns the kernel's G arguments for the chunk:
    (G_re, G_im, g_lo, g_w), the tables None at stride 1."""
    n, b = R.n, R.b
    h = 1.0 / (n + 1)
    omega = complex(2.0 * math.pi * R.wave_num, R.alpha)
    dev = R.c_full.device
    stride = R.factor_stride
    if stride == 1:
        rows = torch.arange(b + k0, b + k0 + c, device=dev)
        tables = None
    else:
        offs, g_lo, g_w = chunk_tables(sweep_rows(R), stride, k0, c)
        _check_chunk_tables(g_lo, offs.shape[0])
        rows = torch.as_tensor(b + offs, device=dev)
        tables = (torch.from_numpy(g_lo).to(dev),
                  torch.from_numpy(g_w).to(dev))
    hm = fd_stencil.build_hm_stencils_rows(
        rows, n, b, R.const, b * h, omega, h, R.c_full, fidelity=R.fidelity,
        complex_dtype=R.TF.dtype)
    T = _schur_corner_inverse(hm)
    count = rows.shape[0]
    G_re, G_im = (p[:count] for p in planes)
    G_re[:, :, :n] = T.real
    G_im[:, :, :n] = T.imag
    del T
    return (G_re, G_im) + (tables or (None, None))


def sweep_rows(R: RecomputeSweepingPreconditioner) -> int:
    """M, the number of sweep rows."""
    return R.grid_shape[0] - R.b


def chunk_plan(R: RecomputeSweepingPreconditioner):
    """The chunks the two sweeps walk, in order, as (k0, c) lists: the
    forward sweep covers rows 0..M-2 bottom-up (full chunks, then the
    tail), the backward sweep rows 0..M-1 top-down (full chunks from the
    top, then the bottom remainder)."""
    M = sweep_rows(R)
    chunk = chunk_rows(R)
    n_full = (M - 1) // chunk
    fwd = [(i * chunk, chunk) for i in range(n_full)]
    if (M - 1) - n_full * chunk:
        fwd.append((n_full * chunk, (M - 1) - n_full * chunk))
    n_full_b = M // chunk
    rem = M - n_full_b * chunk
    bwd = [(rem + (n_full_b - 1 - i) * chunk, chunk)
           for i in range(n_full_b)]
    if rem:
        bwd.append((0, rem))
    return fwd, bwd


def _apply(R: RecomputeSweepingPreconditioner, u: torch.Tensor
           ) -> torch.Tensor:
    """The apply on u of (L, n), or (L, B, n) for a batch (rows outermost,
    as the sweeps take it); u is overwritten and returned."""
    b, n = R.b, R.n
    M = sweep_rows(R)
    multi = u.ndim == 3
    if multi:
        thomas = lambda r: _block_thomas_solve_multi(          # noqa: E731
            R.TF, R.hf_cs, R.hf_cn, r.transpose(0, 1)).transpose(0, 1)
    else:
        thomas = lambda r: _block_thomas_solve(                # noqa: E731
            R.TF, R.hf_cs, R.hf_cn, r)
    fwd, bwd = chunk_plan(R)
    chunk = chunk_rows(R)
    panels = (chunk if R.factor_stride == 1
              else sample_window(chunk, R.factor_stride))
    wf = R.TF.real.dtype
    planes = tuple(torch.zeros((panels, n, g_ld(n)), dtype=wf,
                               device=u.device) for _ in range(2))

    # the three parts of the apply carry named ranges for a profiler trace
    with annotate("recompute.hf"):
        TFuF = thomas(u[:b])
        u[b] -= R.a_cs[b] * TFuF[b - 1]

    # forward sweep, j = b+1..L-1: step k uses G_k, reads row b+k, writes
    # row b+k+1; the carry of a chunk is the row below it, already updated
    for k0, c in fwd:
        with annotate("recompute.refactor"):
            G_re, G_im, g_lo, g_w = _chunk_g(R, k0, c, planes)
        rows = slice(b + 1 + k0, b + 1 + k0 + c)
        with annotate("recompute.sweep"):
            u[rows] = sweep(G_re, G_im, u[rows], R.a_cs[rows], u[b + k0],
                          mode="fwd", g_lo=g_lo, g_w=g_w)

    # fused diagonal + backward sweep, j = L-1..b (G_j at k = j-b), top
    # chunk first; the coupling above the top row is zeroed and the top
    # chunk's carry is zero, every other chunk's is the first row of the
    # chunk above
    cn_top_zeroed = torch.cat(
        [R.a_cn[b:-1], torch.zeros_like(R.a_cn[-1:])], dim=0)
    mode = "bwd" if R.d2_replace else "bwd_sub"
    for k0, c in bwd:
        with annotate("recompute.refactor"):
            G_re, G_im, g_lo, g_w = _chunk_g(R, k0, c, planes)
        rows = slice(b + k0, b + k0 + c)
        carry = torch.zeros_like(u[-1]) if k0 + c == M else u[b + k0 + c]
        with annotate("recompute.sweep"):
            u[rows] = sweep(G_re, G_im, u[rows], cn_top_zeroed[k0:k0 + c],
                            carry, mode=mode, g_lo=g_lo, g_w=g_w)
    del planes

    with annotate("recompute.hf"):
        rhs = torch.zeros_like(TFuF)
        rhs[b - 1] = R.a_cn[b - 1] * u[b]
        u[:b] = TFuF - thomas(rhs)
    return u


@torch.no_grad()
def apply_recompute(R: RecomputeSweepingPreconditioner, f: torch.Tensor
                    ) -> torch.Tensor:
    """One sweep solve u ~= A^{-1} f with G re-derived chunk by chunk: the
    algebra of `sweeping.apply_preconditioner` (corrected or as-shipped
    diagonal step).  f is (L, n) and left untouched."""
    return _apply(R, f.clone())


@torch.no_grad()
def apply_recompute_multi(R: RecomputeSweepingPreconditioner,
                          F: torch.Tensor) -> torch.Tensor:
    """Batched-RHS recompute apply: F of shape (B, L, n) -> (B, L, n), F
    untouched.  All B solves share each chunk's re-factorization (paid once
    for the batch), and each chunk's sweep carries the whole batch (the
    kernel's R-wide mode, in launches of at most four)."""
    u = F.transpose(0, 1).contiguous()
    return _apply(R, u).transpose(0, 1).contiguous()
