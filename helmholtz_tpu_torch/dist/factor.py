"""Assembly and factorization with every rank holding only its band.

The per-m subgrid factorizations are independent, and the assembly of any
band of rows needs only the velocity field and scalars, so each rank:

  1. assembles its band of the global operator A
     (`fd.stencil.build_a_stencil_rows`, `build_a_stencil9_rows`);
  2. assembles the subgrids of its band (row-aligned: the subgrid whose
     corner inverse acts on each of its rows j >= b), or for a strided
     setup only the globally anchored samples that bracket its rows;
  3. factors them into its G planes (`precond.sweeping.
     factor_corner_inverses`; the batched inverses are the blocked
     Gauss-Jordan with the K3 kernel at its base on the card); the F rows'
     panels are zero;
  4. factors the small H_F block-Thomas stack itself (every rank derives
     the same stack from the same scalars, which costs less than sending
     it).

No G stack exists whole anywhere: each rank's setup memory is about its
share of the single-card setup's.  Sample positions and lerp weights are
those of the single-card strided setup (`precond.sweeping.sample_positions`
and `compress_tables`), so the bands' factors equal the single-card
strided stack's, and compressed bands keep only their sample window with
band-local tables (`dist.partition`).
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .._device import real_dtype_of
from ..fd import problems as fd_problems
from ..fd import stencil as fd_stencil
from ..ops.kernels.sweep import g_ld
from ..precond.sweeping import (DEFAULT_SETUP_CHUNK, EXPAND_WORKSPACE_WORDS,
                                _schur_t_stack, factor_corner_inverses,
                                sample_positions)
from ..precond.sweeping9 import (_coupling_triples, _schur_t_stack9,
                                 factor_samples9_assembling)
from .partition import (DistSweepState, DistSweepState9,
                        band_sample_windows, check_band)

_G_DTYPES = {"working": None, "f32": torch.float32, "bf16": torch.bfloat16}


def _stride(M: int, factor_stride: int, g_compress: bool) -> int:
    """The stride the setup uses, with the JAX package's refusals."""
    R = int(factor_stride)
    if R > 1 and M <= R:
        if g_compress:
            raise ValueError(
                f"grid too small for the requested stride: M = n - b = {M} "
                f"sweep rows cannot be sampled at factor_stride = {R} "
                "(need M > stride); drop g_compress or reduce the stride")
        R = 1
    R = max(R, 1)
    if g_compress and R == 1:
        raise ValueError("g_compress requires factor_stride > 1")
    return R


class _Band:
    """The scalars and the band geometry of one rank's setup."""

    def __init__(self, mesh, n, b, wave_num, const, alpha, problem,
                 complex_dtype):
        from ..driver import default_complex_dtype

        self.n, self.b, self.const = n, b, const
        self.n_loc = check_band(n, b, mesh)
        _, self.j0 = mesh.band(n)
        self.dev = mesh.device
        self.cd = complex_dtype or default_complex_dtype(self.dev)
        self.wf = real_dtype_of(self.cd)
        self.omega = complex(2.0 * math.pi * wave_num, alpha)
        self.h = 1.0 / (n + 1)
        self.eta = b * self.h
        self.rows = torch.arange(self.j0, self.j0 + self.n_loc,
                                 device=self.dev)
        self.c_full, self.f_grid = fd_problems.PROBLEMS[problem](
            self.omega, n, complex_dtype=self.cd, device=self.dev)

    @property
    def args(self):
        return (self.n, self.b, self.const, self.eta, self.omega, self.h,
                self.c_full)

    def band_of(self, grid):
        return grid[..., self.j0:self.j0 + self.n_loc, :].contiguous()


def _row_aligned(G_re, G_im, n_loc: int):
    """Planes of the band's real rows (the tail of the band) with zero
    panels in front for the F rows."""
    pad = n_loc - G_re.shape[0]
    if pad == 0:
        return G_re, G_im
    z = torch.zeros((pad, *G_re.shape[1:]), dtype=G_re.dtype,
                    device=G_re.device)
    return torch.cat([z, G_re]), torch.cat([z, G_im])


def _strided_band(geo, mesh, M, R, factor, gdt, g_compress):
    """The band's samples, factored by `factor(pos, g_dtype)`, and either
    kept with band-local tables or lerp-expanded to the band's row-aligned
    dense planes; returns (G_re, G_im, table fields)."""
    b, n_loc = geo.b, geo.n_loc
    pos_all = sample_positions(M, R)
    Ms = pos_all.shape[0]
    windows, ms_loc = band_sample_windows(M, R, b, n_loc, mesh.size)
    s0 = windows[mesh.rank][0]
    sidx = np.minimum(s0 + np.arange(ms_loc), Ms - 1)
    Gs_re, Gs_im = factor(pos_all[sidx], gdt if g_compress else geo.wf)
    rows = np.arange(geo.j0, geo.j0 + n_loc)
    valid = rows >= b
    k = np.clip(rows - b, 0, M - 1)
    lo_g = np.minimum(k // R, Ms - 2)
    if g_compress:
        # the weights of `precond.sweeping.compress_tables`, row by row
        denom = np.maximum(pos_all[lo_g + 1] - pos_all[lo_g], 1)
        t = (k - pos_all[lo_g]) / denom
        g_w = np.where(valid[:, None], np.stack([1.0 - t, t], axis=1), 0.0)
        g_lo = np.where(valid, lo_g - s0, 0)
        return Gs_re, Gs_im, dict(
            g_w=torch.from_numpy(g_w.astype(np.float32)).to(geo.dev),
            g_lo=torch.from_numpy(g_lo.astype(np.int32)).to(geo.dev),
            g_stride=R)
    # dense: `precond.sweeping.expand_strided_samples` on the band's rows
    dev, wf = geo.dev, geo.wf
    n, ld = Gs_re.shape[1:]
    first = int(np.argmax(valid)) if valid.any() else n_loc
    G_re = torch.zeros((n_loc, n, ld), dtype=gdt, device=dev)
    G_im = torch.zeros_like(G_re)
    ks = torch.as_tensor(pos_all, device=dev)
    wchunk = max(4, min(DEFAULT_SETUP_CHUNK, EXPAND_WORKSPACE_WORDS
                        // (n * ld)))
    for start in range(first, n_loc, wchunk):
        stop = min(start + wchunk, n_loc)
        m = torch.as_tensor(k[start:stop], device=dev)
        seg = torch.clamp(m // R, max=Ms - 2)
        lo, hi = ks[seg], ks[seg + 1]
        w = ((m - lo).to(wf) / torch.clamp(hi - lo, min=1).to(wf))[:, None,
                                                                   None]
        loc = seg - s0
        for T, G in ((Gs_re, G_re), (Gs_im, G_im)):
            G[start:stop] = (1.0 - w) * T[loc] + w * T[loc + 1]
    return G_re, G_im, {}


def distributed_setup(mesh, n: int, b: int, wave_num, const, alpha=2.0,
                      problem: str = "c1_f1", *,
                      fidelity: str = "corrected",
                      g_dtype: str = "working",
                      hf_full_coupling: bool = True,
                      d2_replace: bool = True,
                      setup_chunk: int = DEFAULT_SETUP_CHUNK,
                      factor_stride: int = 1,
                      g_compress: bool = False,
                      complex_dtype=None):
    """Assemble and factor this rank's band of the 5-point problem: returns
    (A_band, DistSweepState, f_band) on the mesh's device.

    `factor_stride` > 1 factors only the globally anchored sample subgrids
    that bracket the band (each rank assembles its own, so no sample
    crosses a band seam); `g_compress=True` keeps them as the band's
    sample window with band-local lerp tables, else they are lerp-expanded
    to the band's dense panels at `g_dtype`.
    """
    geo = _Band(mesh, n, b, wave_num, const, alpha, problem, complex_dtype)
    M = n - b
    R = _stride(M, factor_stride, g_compress)
    gdt = _G_DTYPES[g_dtype] or geo.wf
    kw = dict(fidelity=fidelity, complex_dtype=geo.cd)
    A_band = fd_stencil.build_a_stencil_rows(geo.rows, *geo.args, **kw)

    def factor(pos, dtype):
        hm = fd_stencil.build_hm_stencils_rows(
            b + torch.as_tensor(pos, device=geo.dev), *geo.args, **kw)
        return factor_corner_inverses(hm, g_dtype=dtype,
                                      setup_chunk=setup_chunk)

    if R == 1:
        real = geo.rows[geo.rows >= b].cpu().numpy()
        G_re, G_im = _row_aligned(*factor(real - b, gdt), geo.n_loc)
        tables = {}
    else:
        G_re, G_im, tables = _strided_band(geo, mesh, M, R, factor, gdt,
                                           g_compress)
    # H_F after G, as on one card: its stack is not held during the setup
    HF = fd_stencil.build_hf_stencil(*geo.args,
                                     full_coupling=hf_full_coupling, **kw)
    state = DistSweepState(
        G_re=G_re, G_im=G_im, TF=_schur_t_stack(HF), hf_cs=HF.cs,
        hf_cn=HF.cn,
        a_cs=A_band.cs.contiguous(), a_cn=A_band.cn.contiguous(), b=b,
        d2_replace=d2_replace, **tables)
    return A_band, state, geo.band_of(geo.f_grid)


def _tf9(HF, gdt):
    """H_F's 9-point stack with its values rounded to the G storage type,
    held widened (`precond.sweeping9._with_hf9`)."""
    TF = _schur_t_stack9(HF)
    if gdt != TF.real.dtype:
        TF = torch.complex(TF.real.to(gdt).to(TF.real.dtype),
                           TF.imag.to(gdt).to(TF.real.dtype))
    return TF


def distributed_setup9(mesh, n: int, b: int, wave_num, const, alpha=2.0,
                       problem: str = "c1_f1", *,
                       gamma: float = 2.0 / 3.0,
                       fidelity: str = "corrected",
                       g_dtype: str = "working",
                       d2_replace: bool = True,
                       setup_chunk: int = DEFAULT_SETUP_CHUNK,
                       factor_stride: int = 1,
                       g_compress: bool = False,
                       complex_dtype=None):
    """`distributed_setup` for the 9-point scheme: the tridiagonal-coupling
    Schur recursion on the band's subgrids (assembled chunk by chunk inside
    the factor loop, `precond.sweeping9.factor_samples9_assembling`),
    coupling triples in the state, and the Mehrstellen-filtered forcing."""
    geo = _Band(mesh, n, b, wave_num, const, alpha, problem, complex_dtype)
    M = n - b
    R = _stride(M, factor_stride, g_compress)
    gdt = _G_DTYPES[g_dtype] or geo.wf
    kw = dict(gamma=gamma, fidelity=fidelity, complex_dtype=geo.cd)
    A_band = fd_stencil.build_a_stencil9_rows(geo.rows, *geo.args, **kw)

    def factor(pos, dtype):
        return factor_samples9_assembling(
            *geo.args, gamma=gamma, pos=pos, g_dtype=dtype,
            setup_chunk=setup_chunk, fidelity=fidelity,
            complex_dtype=geo.cd)

    if R == 1:
        real = geo.rows[geo.rows >= b].cpu().numpy()
        G_re, G_im = _row_aligned(*factor(real - b, gdt), geo.n_loc)
        tables = {}
    else:
        G_re, G_im, tables = _strided_band(geo, mesh, M, R, factor, gdt,
                                           g_compress)
    HF = fd_stencil.build_hf_stencil9(*geo.args, **kw)
    hf_l, hf_u = _coupling_triples(HF)
    a_l, a_u = _coupling_triples(A_band)
    state = DistSweepState9(
        G_re=G_re, G_im=G_im, TF=_tf9(HF, gdt), hf_l=hf_l, hf_u=hf_u,
        a_l=a_l, a_u=a_u, b=b, d2_replace=d2_replace, **tables)
    f9 = fd_stencil.mass_filter9(n, b, const, geo.eta, geo.omega, geo.h,
                                 geo.f_grid)
    return A_band, state, geo.band_of(f9)


def _placeholder(geo):
    """Empty G planes for a state whose G the caller supplies."""
    return torch.zeros((0, geo.n, g_ld(geo.n)), dtype=geo.wf,
                       device=geo.dev)


def distributed_assemble(mesh, n: int, b: int, wave_num, const, alpha=2.0,
                         problem: str = "c1_f1", *,
                         fidelity: str = "corrected",
                         d2_replace: bool = True,
                         hf_full_coupling: bool = True,
                         complex_dtype=None):
    """The band's assembly and H_F factorization WITHOUT the subgrids: the
    per-frequency work of an omega-amortized distributed sweep
    (`driver.run_multisolve(freq_anchor_every=...)`).  Returns what
    `distributed_setup` returns, with empty G planes that the caller
    replaces by the omega-lerp of two anchors' band samples (the tables are
    frequency-independent)."""
    geo = _Band(mesh, n, b, wave_num, const, alpha, problem, complex_dtype)
    kw = dict(fidelity=fidelity, complex_dtype=geo.cd)
    A_band = fd_stencil.build_a_stencil_rows(geo.rows, *geo.args, **kw)
    HF = fd_stencil.build_hf_stencil(*geo.args,
                                     full_coupling=hf_full_coupling, **kw)
    G = _placeholder(geo)
    state = DistSweepState(
        G_re=G, G_im=G, TF=_schur_t_stack(HF), hf_cs=HF.cs, hf_cn=HF.cn,
        a_cs=A_band.cs.contiguous(), a_cn=A_band.cn.contiguous(), b=b,
        d2_replace=d2_replace)
    return A_band, state, geo.band_of(geo.f_grid)


def distributed_assemble9(mesh, n: int, b: int, wave_num, const, alpha=2.0,
                          problem: str = "c1_f1", *,
                          gamma: float = 2.0 / 3.0,
                          fidelity: str = "corrected",
                          d2_replace: bool = True,
                          g_dtype: str = "working",
                          complex_dtype=None):
    """`distributed_assemble` for the 9-point scheme; H_F's stack is rounded
    to `g_dtype`, the type of the G the caller supplies."""
    geo = _Band(mesh, n, b, wave_num, const, alpha, problem, complex_dtype)
    kw = dict(gamma=gamma, fidelity=fidelity, complex_dtype=geo.cd)
    A_band = fd_stencil.build_a_stencil9_rows(geo.rows, *geo.args, **kw)
    HF = fd_stencil.build_hf_stencil9(*geo.args, **kw)
    hf_l, hf_u = _coupling_triples(HF)
    a_l, a_u = _coupling_triples(A_band)
    G = _placeholder(geo)
    state = DistSweepState9(
        G_re=G, G_im=G, TF=_tf9(HF, _G_DTYPES[g_dtype] or geo.wf), hf_l=hf_l,
        hf_u=hf_u, a_l=a_l, a_u=a_u, b=b, d2_replace=d2_replace)
    f9 = fd_stencil.mass_filter9(n, b, const, geo.eta, geo.omega, geo.h,
                                 geo.f_grid)
    return A_band, state, geo.band_of(f9)
