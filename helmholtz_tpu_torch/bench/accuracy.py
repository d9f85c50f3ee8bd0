"""Discretization-accuracy study: the 5-point against the 9-point scheme.

Ported from the JAX package's `bench/accuracy.py`.  Method: a manufactured
solution with EXACT forcing.  u*(x) is a plane wave exp(i omega d.x)
windowed by a Gaussian bump centred in the unit square and negligible
(< 1e-12 relative) within several sigma of every boundary, so the PML and
Dirichlet layers see about zero field and the measured error is the
INTERIOR scheme's discretization error alone.  The forcing
f = Delta u* + omega^2 u* (c = 1) is the closed form of the windowed plane
wave's second derivatives (the JAX package takes them by forward-mode
autodiff; the two agree to rounding), sampled on the grid, and the discrete
system A_h u_h = f_h is solved through the port's own pipeline to an
algebraic tolerance far below the discretization error.  Error metric:
relative L2 of u_h - u* over the interior box [1/4, 3/4]^2.

Two sweeps, emitted as JSONL rows (the JAX package's are ACCURACY.jsonl):
  * refine: n doubles at fixed omega, the convergence order of each scheme;
  * ppw: omega sweeps at fixed n, the error against points per wavelength.

On the card the working type is complex64 with `precision="ir-df32"`
(refinement in complex128 around the complex64 solve), as the JAX package
ran on its accelerator; on the CPU it is complex128.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import torch

from .._device import real_dtype_of, resolve_device
from ..driver import (_set_full_float32, _solve_stage, _sync,
                      default_complex_dtype, min_pml_width9)
from ..fd import stencil as fd_stencil
from ..precond.sweeping import setup_preconditioner
from ..precond.sweeping9 import setup_preconditioner9


def manufactured_fields(omega, direction=(0.8, 0.6), center=(0.5, 0.5),
                        sigma=0.08):
    """(u_fn, f_fn): the windowed plane wave and its EXACT Helmholtz
    forcing f = u_xx + u_yy + omega^2 u (c = 1), both mapping real grids
    (x1, x2) (torch tensors) to complex tensors of the matching precision.

    With u = exp(g), g = -|x - c|^2 / (2 sigma^2) + i omega d.x, each
    second derivative is u_xkxk = (g_xk^2 + g_xkxk) u with
    g_xk = -(x_k - c_k) / sigma^2 + i omega d_k and g_xkxk = -1 / sigma^2."""
    om = complex(omega)
    d1, d2 = direction
    nrm = (d1 * d1 + d2 * d2) ** 0.5
    d1, d2 = d1 / nrm, d2 / nrm
    c1, c2 = center
    s2 = sigma * sigma

    def u_fn(x1, x2):
        cd = torch.complex128 if x1.dtype == torch.float64 else \
            torch.complex64
        phase = (d1 * x1 + d2 * x2).to(cd) * om
        bump = torch.exp(-((x1 - c1) ** 2 + (x2 - c2) ** 2) / (2.0 * s2))
        return bump.to(cd) * torch.exp(1j * phase)

    def f_fn(x1, x2):
        u = u_fn(x1, x2)
        g1 = (-(x1 - c1) / s2).to(u.dtype) + 1j * om * d1
        g2 = (-(x2 - c2) / s2).to(u.dtype) + 1j * om * d2
        return (g1 * g1 + g2 * g2 - 2.0 / s2 + om * om) * u

    return u_fn, f_fn


def measure_error(n, wave_num, stencil="5pt", *, b=None, const=60.0,
                  alpha=2.0, gamma=2.0 / 3.0, rtol=1e-8, maxiter=200,
                  restart=30, complex_dtype=None, sigma=0.08,
                  device="cuda"):
    """One (n, omega, stencil) accuracy point.  Returns the record dict.

    The solve runs the port's own pipeline (assembly, the sweeping
    preconditioner's setup, GMRES through `driver._solve_stage`;
    `precision="ir-df32"` when the working type is complex64), so the
    record also certifies the production path end to end at an algebraic
    tolerance about 100x below the smallest discretization error measured.
    With the default device and no card this raises."""
    dev = resolve_device(device)
    _set_full_float32()
    cdtype = complex_dtype or default_complex_dtype(dev)
    wf = real_dtype_of(cdtype)
    if b is None:
        b = max(12, min_pml_width9(n)) if stencil == "9pt" else 12
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    eta = b * h
    xs = torch.arange(1, n + 1, dtype=wf, device=dev) * h
    X1, X2 = torch.meshgrid(xs, xs, indexing="xy")   # [row=j->x2, col=i->x1]
    u_fn, f_fn = manufactured_fields(omega, sigma=sigma)
    u_star = u_fn(X1, X2).cpu().numpy().astype(np.complex128)
    c_full = torch.ones((n + 2, n + 2), dtype=wf, device=dev)

    _sync(dev)
    t0 = time.perf_counter()
    f = f_fn(X1, X2).to(cdtype)
    kw = dict(fidelity="corrected", complex_dtype=cdtype)
    if stencil == "9pt":
        A = fd_stencil.build_a_stencil9(n, b, const, eta, omega, h, c_full,
                                        gamma=gamma, **kw)
        hm = fd_stencil.build_hm_stencils9(n, b, const, eta, omega, h,
                                           c_full, gamma=gamma, **kw)
        P = setup_preconditioner9(A, hm, b, device=dev)
        # the compact scheme's system is A9 u = M f
        f = fd_stencil.mass_filter9(n, b, const, eta, omega, h, f)
    else:
        A = fd_stencil.build_a_stencil(n, b, const, eta, omega, h, c_full,
                                       **kw)
        hm = fd_stencil.build_hm_stencils(n, b, const, eta, omega, h,
                                          c_full, **kw)
        P = setup_preconditioner(A, hm, b, device=dev)
    del hm
    _sync(dev)
    init_s = time.perf_counter() - t0

    precision = "ir-df32" if cdtype == torch.complex64 else "f32"
    t0 = time.perf_counter()
    res = _solve_stage(A, P, f, rtol, restart=restart, maxiter=maxiter,
                       use_precond=True, precision=precision, device=dev)
    u_h = res.x.cpu().numpy().reshape(n, n).astype(np.complex128)
    solve_s = time.perf_counter() - t0

    # interior-box error, far from the PML and the bump tails
    i0, i1 = int(0.25 * (n + 1)), int(0.75 * (n + 1))
    box = np.s_[i0:i1, i0:i1]
    err = (np.linalg.norm((u_h - u_star)[box])
           / np.linalg.norm(u_star[box]))
    ppw = (n + 1) / wave_num
    return {
        "study": None, "stencil": stencil, "n": n, "b": b,
        "wave_num": float(wave_num), "ppw": round(float(ppw), 2),
        "const": const, "gamma": (gamma if stencil == "9pt" else None),
        "err_rel_interior": float(err),
        "iterations": int(res.iterations),
        "converged": bool(res.converged),
        "algebraic_rtol": rtol, "precision": precision,
        "init_s": round(init_s, 2), "solve_s": round(solve_s, 2),
        "dtype": str(cdtype).replace("torch.", ""), "sigma": sigma,
        "device": str(dev),
    }


def run_study(ns=(63, 127, 255), wave_num_refine=8.0, n_ppw=255,
              wave_nums_ppw=(8.0, 16.0, 24.0, 32.0), out=None, **kw):
    """The full two-sweep study; one JSONL row per point."""
    rows = []

    def emit(rec):
        rows.append(rec)
        line = json.dumps(rec)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")

    for n in ns:
        for stencil in ("5pt", "9pt"):
            rec = measure_error(n, wave_num_refine, stencil, **kw)
            rec["study"] = "refine"
            emit(rec)
    for wn in wave_nums_ppw:
        for stencil in ("5pt", "9pt"):
            rec = measure_error(n_ppw, wn, stencil, **kw)
            rec["study"] = "ppw"
            emit(rec)
    return rows


def convergence_orders(rows):
    """{stencil: [orders]} from consecutive refine-study pairs."""
    out = {}
    for stencil in ("5pt", "9pt"):
        pts = sorted([r for r in rows
                      if r["study"] == "refine" and r["stencil"] == stencil],
                     key=lambda r: r["n"])
        orders = []
        for a, c in zip(pts, pts[1:]):
            ha, hc = 1.0 / (a["n"] + 1), 1.0 / (c["n"] + 1)
            orders.append(np.log(a["err_rel_interior"]
                                 / c["err_rel_interior"])
                          / np.log(ha / hc))
        out[stencil] = [round(float(o), 2) for o in orders]
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(prog="helmholtz_tpu_torch.bench.accuracy")
    ap.add_argument("--ns", type=int, nargs="+", default=[63, 127, 255])
    ap.add_argument("--n-ppw", type=int, default=255)
    ap.add_argument("--wave-num-refine", type=float, default=8.0)
    ap.add_argument("--wave-nums-ppw", type=float, nargs="+",
                    default=[8.0, 16.0, 24.0, 32.0])
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    rows = run_study(tuple(args.ns), args.wave_num_refine, args.n_ppw,
                     tuple(args.wave_nums_ppw), out=args.out,
                     device=args.device)
    print(json.dumps({"convergence_orders": convergence_orders(rows)}),
          file=sys.stderr)
    return 0


if __name__ == "__main__":
    sys.exit(main())
