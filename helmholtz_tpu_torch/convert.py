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
from .core.sparse import Stencil5
from .ops.kernels.sweep import g_ld
from .precond.sweeping import SweepingPreconditioner


def _complex_tensor(z, dev):
    return torch.from_numpy(np.array(z, order="C")).to(dev)   # a copy


def stencil5_from_numpy(cc, cw, ce, cs, cn, *, device="cuda") -> Stencil5:
    """A Stencil5 from five complex numpy fields of one shape."""
    dev = resolve_device(device)
    return Stencil5(*(_complex_tensor(f, dev) for f in (cc, cw, ce, cs, cn)))


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
    tables = {}
    if g_stride:
        tables = dict(
            g_w=torch.from_numpy(np.array(g_w, np.float32)).to(dev),
            g_lo=torch.from_numpy(np.array(g_lo, np.int32)).to(dev),
            g_stride=int(g_stride))
    return SweepingPreconditioner(
        G_re=g_planes_from_numpy(G_re, n, g_dtype=g_dtype, device=dev),
        G_im=g_planes_from_numpy(G_im, n, g_dtype=g_dtype, device=dev),
        TF=_complex_tensor(TF, dev),
        hf_cs=_complex_tensor(hf_cs, dev), hf_cn=_complex_tensor(hf_cn, dev),
        a_cs=_complex_tensor(a_cs, dev), a_cn=_complex_tensor(a_cn, dev),
        b=b, d2_replace=d2_replace, **tables)
