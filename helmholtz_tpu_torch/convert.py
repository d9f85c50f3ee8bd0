"""Build the port's objects from another implementation's arrays.

The functions take plain numpy arrays (for example `np.asarray` of the JAX
package's fields) and never import that package, so a test can apply the
port's sweep to a G stack factored elsewhere, or run the port's GMRES on an
operator assembled elsewhere, and pin a mismatch to one stage.
"""
from __future__ import annotations

import numpy as np
import torch

from ._device import resolve_device
from .core.sparse import BSR, CSR, Stencil5, Stencil9, _index
from .ops.kernels.sweep import g_ld
from .precond.exact import ExactFactorization
from .precond.sweeping import SweepingPreconditioner
from .precond.sweeping9 import SweepingPreconditioner9


def _complex_tensor(z, dev):
    return torch.from_numpy(np.array(z, order="C")).to(dev)   # a copy


def stencil5_from_numpy(cc, cw, ce, cs, cn, *, device="cuda") -> Stencil5:
    """A Stencil5 from five complex numpy fields of one shape."""
    dev = resolve_device(device)
    return Stencil5(*(_complex_tensor(f, dev) for f in (cc, cw, ce, cs, cn)))


def stencil9_from_numpy(*fields, device="cuda") -> Stencil9:
    """A Stencil9 from nine complex numpy fields of one shape, in the order
    cc, cw, ce, cs, cn, csw, cse, cnw, cne."""
    dev = resolve_device(device)
    if len(fields) != 9:
        raise ValueError(f"a Stencil9 has nine fields, got {len(fields)}")
    return Stencil9(*(_complex_tensor(f, dev) for f in fields))


def csr_from_numpy(data, indices, indptr, shape, *, device="cuda") -> CSR:
    """A CSR matrix from its numpy arrays; indices are stored as int32."""
    dev = resolve_device(device)
    return CSR(_complex_tensor(data, dev), _index(indices, dev),
               _index(indptr, dev), tuple(shape))


def bsr_from_numpy(data, indices, indptr, shape, blocksize, *,
                   device="cuda") -> BSR:
    """A BSR matrix from its numpy arrays: blocks (nblocks, bm, bn) in CSR
    order, block-column indices and indptr (stored as int32)."""
    dev = resolve_device(device)
    return BSR(_complex_tensor(data, dev), _index(indices, dev),
               _index(indptr, dev), tuple(shape), tuple(blocksize))


def exact_factorization_from_numpy(T, cs, cn, *,
                                   device="cuda") -> ExactFactorization:
    """An ExactFactorization from its complex numpy stack T (L, n, n) and
    couplings cs, cn (L, n)."""
    dev = resolve_device(device)
    return ExactFactorization(T=_complex_tensor(T, dev),
                              cs=_complex_tensor(cs, dev),
                              cn=_complex_tensor(cn, dev))


def g_planes_from_numpy(G, n: int, *, g_dtype=None, device="cuda"):
    """One real G plane (M, n, n) or zero-padded (M, n_pad, n_pad), n_pad >=
    n, re-pitched to the port's (M, n, g_ld(n)) layout with zero pad
    columns.  `g_dtype` is the storage type (default: the array's own)."""
    dev = resolve_device(device)
    G = np.asarray(G)
    if G.ndim != 3 or G.shape[1] < n or G.shape[2] < n:
        raise ValueError(f"expected a (M, >={n}, >={n}) plane, got {G.shape}")
    src = torch.from_numpy(np.array(G[:, :n, :n], order="C"))
    out = torch.zeros((G.shape[0], n, g_ld(n)), dtype=g_dtype or src.dtype,
                      device=dev)
    out[:, :, :n] = src.to(dev)
    return out


def _tables_from_numpy(g_w, g_lo, g_stride, dev) -> dict:
    if not g_stride:
        return {}
    return dict(g_w=torch.from_numpy(np.array(g_w, np.float32)).to(dev),
                g_lo=torch.from_numpy(np.array(g_lo, np.int32)).to(dev),
                g_stride=int(g_stride))


def preconditioner_from_numpy(G_re, G_im, TF, hf_cs, hf_cn, a_cs, a_cn,
                              b: int, d2_replace: bool, n: int, *,
                              g_dtype=None, g_w=None, g_lo=None,
                              g_stride: int = 0,
                              device="cuda") -> SweepingPreconditioner:
    """A SweepingPreconditioner from numpy state: real G planes in either
    layout `g_planes_from_numpy` takes, and complex TF (b, n, n), hf_cs,
    hf_cn (b, n), a_cs, a_cn (L, n).  For a sample-compressed stack
    (g_stride > 0) also the lerp tables g_w (M, 2) and g_lo (M,), stored as
    float32 and int32."""
    dev = resolve_device(device)
    tables = _tables_from_numpy(g_w, g_lo, g_stride, dev)
    return SweepingPreconditioner(
        G_re=g_planes_from_numpy(G_re, n, g_dtype=g_dtype, device=dev),
        G_im=g_planes_from_numpy(G_im, n, g_dtype=g_dtype, device=dev),
        TF=_complex_tensor(TF, dev),
        hf_cs=_complex_tensor(hf_cs, dev), hf_cn=_complex_tensor(hf_cn, dev),
        a_cs=_complex_tensor(a_cs, dev), a_cn=_complex_tensor(a_cn, dev),
        b=b, d2_replace=d2_replace, **tables)


def preconditioner9_from_numpy(G_re, G_im, TF, hf_l, hf_u, a_l, a_u, b: int,
                               d2_replace: bool, n: int, *, g_dtype=None,
                               g_w=None, g_lo=None, g_stride: int = 0,
                               device="cuda") -> SweepingPreconditioner9:
    """A SweepingPreconditioner9 from numpy state: real G planes in either
    layout `g_planes_from_numpy` takes, complex TF (b, n, n) (its values
    already rounded to whatever type stored them), the coupling rows hf_l,
    hf_u (b, 3, n) and a_l, a_u (L, 3, n) as [sub, diag, sup], and for a
    sample-compressed stack (g_stride > 0) the lerp tables."""
    dev = resolve_device(device)
    return SweepingPreconditioner9(
        G_re=g_planes_from_numpy(G_re, n, g_dtype=g_dtype, device=dev),
        G_im=g_planes_from_numpy(G_im, n, g_dtype=g_dtype, device=dev),
        TF=_complex_tensor(TF, dev),
        hf_l=_complex_tensor(hf_l, dev), hf_u=_complex_tensor(hf_u, dev),
        a_l=_complex_tensor(a_l, dev), a_u=_complex_tensor(a_u, dev),
        b=b, d2_replace=d2_replace,
        **_tables_from_numpy(g_w, g_lo, g_stride, dev))


def _band_planes(G_re, G_im, n, L, rank, n_devices, g_stride, g_dtype, dev):
    """Rank `rank`'s G planes from the global row-aligned (L, .., ..) or
    per-band sample (n_devices * Ms_loc, .., ..) planes."""
    per = np.asarray(G_re).shape[0] // n_devices
    if not g_stride and per != L // n_devices:
        raise ValueError(f"dense planes have {per * n_devices} panels for "
                         f"{L} rows")
    sl = slice(rank * per, (rank + 1) * per)
    return (g_planes_from_numpy(np.asarray(G_re)[sl], n, g_dtype=g_dtype,
                                device=dev),
            g_planes_from_numpy(np.asarray(G_im)[sl], n, g_dtype=g_dtype,
                                device=dev))


def _band_tables(g_w, g_lo, g_stride, rows, dev) -> dict:
    if not g_stride:
        return {}
    return _tables_from_numpy(np.asarray(g_w)[rows], np.asarray(g_lo)[rows],
                              g_stride, dev)


def dist_state_from_numpy(G_re, G_im, TF, hf_cs, hf_cn, a_cs, a_cn, b: int,
                          d2_replace: bool, n: int, *, rank: int,
                          n_devices: int, g_dtype=None, g_w=None, g_lo=None,
                          g_stride: int = 0, device="cuda"):
    """Rank `rank`'s band (`dist.partition.DistSweepState`) of another
    implementation's GLOBAL distributed 5-point state, as numpy leaves: G
    planes row-aligned (L, n(_pad), n(_pad)) with zero F panels, or for a
    sample-compressed state (g_stride > 0) the bands' sample windows one
    after another (n_devices * Ms_loc panels) with per-row local tables
    g_w (L, 2) and g_lo (L,); TF (b, n, n), hf_cs, hf_cn (b, n); the
    couplings a_cs, a_cn (L, n)."""
    from .dist.partition import DistSweepState

    dev = resolve_device(device)
    L = np.asarray(a_cs).shape[0]
    n_loc = L // n_devices
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    G = _band_planes(G_re, G_im, n, L, rank, n_devices, g_stride, g_dtype,
                     dev)
    return DistSweepState(
        G_re=G[0], G_im=G[1], TF=_complex_tensor(TF, dev),
        hf_cs=_complex_tensor(hf_cs, dev), hf_cn=_complex_tensor(hf_cn, dev),
        a_cs=_complex_tensor(np.asarray(a_cs)[rows], dev),
        a_cn=_complex_tensor(np.asarray(a_cn)[rows], dev), b=b,
        d2_replace=d2_replace,
        **_band_tables(g_w, g_lo, g_stride, rows, dev))


def dist_state9_from_numpy(G_re, G_im, TF, hf_l, hf_u, a_l, a_u, b: int,
                           d2_replace: bool, n: int, *, rank: int,
                           n_devices: int, g_dtype=None, g_w=None, g_lo=None,
                           g_stride: int = 0, device="cuda"):
    """`dist_state_from_numpy` for the 9-point state
    (`dist.partition.DistSweepState9`): coupling triples hf_l, hf_u
    (b, 3, n) and a_l, a_u (L, 3, n), and TF complex (b, n, n) with its
    values already rounded to whatever type stored them."""
    from .dist.partition import DistSweepState9

    dev = resolve_device(device)
    L = np.asarray(a_l).shape[0]
    n_loc = L // n_devices
    rows = slice(rank * n_loc, (rank + 1) * n_loc)
    G = _band_planes(G_re, G_im, n, L, rank, n_devices, g_stride, g_dtype,
                     dev)
    return DistSweepState9(
        G_re=G[0], G_im=G[1], TF=_complex_tensor(TF, dev),
        hf_l=_complex_tensor(hf_l, dev), hf_u=_complex_tensor(hf_u, dev),
        a_l=_complex_tensor(np.asarray(a_l)[rows], dev),
        a_u=_complex_tensor(np.asarray(a_u)[rows], dev), b=b,
        d2_replace=d2_replace,
        **_band_tables(g_w, g_lo, g_stride, rows, dev))
