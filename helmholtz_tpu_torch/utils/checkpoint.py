"""Checkpoint / resume of factored state and solver artifacts.

The setup products, the G stack and the H_F factors, go to one .npz of
split-real numpy arrays, so a multi-frequency sweep or a restarted job
reuses setup across processes.  The file format is the JAX package's
(`utils/checkpoint.py`), so files move both ways between the packages:

  * `G_re` / `G_im` are (M, n, n), without the port's pad columns;
  * `TF`, `hf_cs`, `hf_cn`, `a_cs`, `a_cn` as `<name>_re` / `<name>_im`;
  * `g_w` (M, 2) and `g_lo` (M,) for a sample-compressed stack;
  * `_meta`, JSON bytes: `b`, `d2_replace`, `g_stride`, and from the port
    `g_dtype`.  numpy has no bfloat16, so the port writes bfloat16 planes
    as float32 (which holds every bfloat16 value exactly) and records
    "bf16" there; the JAX loader reads only the first three keys.

The loader re-pitches G to the port's (M, n, g_ld(n)) layout on the
requested device, restores the storage type, reads bfloat16 planes that
the JAX package wrote, and rebuilds the lerp tables of the round-3
compressed format (1-D `g_w`, no `g_lo`) through
`precond.sweeping.compress_tables`.
"""
from __future__ import annotations

import json

import numpy as np
import torch

from .._device import resolve_device
from ..ops.kernels.sweep import g_ld
from ..precond.sweeping import SweepingPreconditioner, compress_tables

_COMPLEX_FIELDS = ["TF", "hf_cs", "hf_cn", "a_cs", "a_cn"]
_G_DTYPES = {"bf16": torch.bfloat16, "f32": torch.float32,
             "f64": torch.float64}


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def save_preconditioner(path: str, P: SweepingPreconditioner) -> str:
    n = P.grid_shape[1]
    g_dtype = {v: k for k, v in _G_DTYPES.items()}[P.G_re.dtype]
    arrays = {}
    for name, plane in (("G_re", P.G_re), ("G_im", P.G_im)):
        plane = plane[:, :, :n]
        if plane.dtype == torch.bfloat16:
            plane = plane.float()
        arrays[name] = _np(plane)
    for name in _COMPLEX_FIELDS:
        z = _np(getattr(P, name))
        arrays[f"{name}_re"] = np.real(z)
        arrays[f"{name}_im"] = np.imag(z)
    if P.g_stride:
        arrays["g_w"] = _np(P.g_w)
        arrays["g_lo"] = _np(P.g_lo)
    arrays["_meta"] = np.frombuffer(
        json.dumps({"b": P.b, "d2_replace": P.d2_replace,
                    "g_stride": int(P.g_stride),
                    "g_dtype": g_dtype}).encode(), dtype=np.uint8)
    np.savez_compressed(path, **arrays)
    return path


def _complex(re: np.ndarray, im: np.ndarray) -> np.ndarray:
    """re + i im at the complex type of the planes' float type."""
    z = np.empty(re.shape, np.result_type(re.dtype, np.complex64))
    z.real, z.imag = re, im
    return z


def _plane(a: np.ndarray) -> torch.Tensor:
    """A stored G plane as a CPU tensor; a bfloat16 plane that the JAX
    package wrote comes back from numpy as 2-byte void records."""
    if a.dtype.kind == "V" and a.dtype.itemsize == 2:
        return torch.from_numpy(np.ascontiguousarray(a).view(np.int16)) \
            .view(torch.bfloat16)
    return torch.from_numpy(np.ascontiguousarray(a))


def load_preconditioner(path: str, device="cuda") -> SweepingPreconditioner:
    dev = resolve_device(device)
    z = np.load(path)
    meta = json.loads(bytes(z["_meta"]).decode())
    b = int(meta["b"])
    cplx = {name: _complex(z[f"{name}_re"], z[f"{name}_im"])
            for name in _COMPLEX_FIELDS}
    L, n = cplx["a_cs"].shape
    g_stride = int(meta.get("g_stride", 0))
    g_w = g_lo = None
    if g_stride:
        if "g_lo" in z.files and np.asarray(z["g_w"]).ndim == 2:
            g_w, g_lo = z["g_w"], z["g_lo"]
        else:
            # round-3 format: 1-D weights, no lo table; the tables are
            # static given (M, stride), so rebuild them
            g_w, g_lo = compress_tables(L - b, g_stride)
    G = [_plane(z[name]) for name in ("G_re", "G_im")]
    g_dtype = _G_DTYPES.get(meta.get("g_dtype"), G[0].dtype)
    planes = []
    for g in G:
        out = torch.zeros((g.shape[0], n, g_ld(n)), dtype=g_dtype,
                          device=dev)
        out[:, :, :n] = g[:, :n, :n].to(dev)
        planes.append(out)
    cplx = {k: torch.from_numpy(v).to(dev) for k, v in cplx.items()}
    tables = {}
    if g_stride:
        as_t = lambda a, t: torch.from_numpy(np.array(a, t)).to(dev)  # noqa
        tables = dict(g_w=as_t(g_w, np.float32), g_lo=as_t(g_lo, np.int32),
                      g_stride=g_stride)
    return SweepingPreconditioner(
        G_re=planes[0], G_im=planes[1], **cplx, b=b,
        d2_replace=bool(meta["d2_replace"]), **tables)


def save_report(path: str, report) -> str:
    """Persist a SolveReport: solution + residual history + metrics."""
    np.savez_compressed(
        path,
        u_re=np.real(report.u), u_im=np.imag(report.u),
        history=report.history,
        _meta=np.frombuffer(json.dumps(report.metrics()).encode(),
                            dtype=np.uint8))
    return path


def load_report_arrays(path: str):
    z = np.load(path)
    meta = json.loads(bytes(z["_meta"]).decode())
    return z["u_re"] + 1j * z["u_im"], z["history"], meta
