"""complex128 CPU oracle for GMRES iteration-count parity at scale.

Ported from the JAX package's `bench/ref_oracle.py`.  It runs the
*corrected* sweeping algorithm in scipy complex128 at any n, with SuperLU
for every subgrid solve, as the reference code's algorithms 2.3 / 2.4 do,
so its iteration counts are the parity target for the solve on the card.

The operators come from the port's own assembly with `device="cpu"` in
complex128 (held to the JAX package's at 1e-12 by the port's assembly
tests); only the factorization, the sweep and GMRES are scipy here, a
different lineage from the card's path (batched Schur corner inverses), so
the two cross-check each other.  Nothing here touches the card.

Run:  python -m helmholtz_tpu_torch.bench.ref_oracle --n 1023 --rtols 1e-3 1e-6
Emits one JSON line per (n, rtol); the JAX package's records for the bench
configurations are ORACLE.json.
"""
from __future__ import annotations

import argparse
import json
import math
import sys
import time

import numpy as np
import scipy.sparse as sp
import scipy.sparse.linalg as spla
import torch

from ..fd import problems as fd_problems
from ..fd import stencil as fd_stencil

_FIELDS5 = ("cc", "cw", "ce", "cs", "cn")
_FIELDS9 = _FIELDS5 + ("csw", "cse", "cnw", "cne")


def _cpu_problem(n, b, wave_num, alpha, problem):
    """(omega, h, eta, c_full, f_grid) of the port's problem on the CPU in
    complex128."""
    omega = complex(2.0 * math.pi * wave_num, alpha)
    h = 1.0 / (n + 1)
    c_full, f_grid = fd_problems.PROBLEMS[problem](
        omega, n, complex_dtype=torch.complex128, device="cpu")
    return omega, h, b * h, c_full, f_grid


def _fields(S, names):
    """Stencil fields as numpy complex128 arrays, by name."""
    return {k: getattr(S, k).numpy() for k in names}


def _strip_to_csc(f):
    """(L, n) 5-point stencil fields -> scipy CSC with offsets 0, +-1,
    +-n."""
    nn = f["cc"].shape[-1]
    cc, cw, ce, cs, cn = (f[k].reshape(-1) for k in _FIELDS5)
    return sp.diags([cc, cw[1:], ce[:-1], cs[nn:], cn[:-nn]],
                    [0, -1, 1, -nn, nn], format="csc")


def _setup_scipy(n, b, wave_num, const, alpha, problem="c1_f1",
                 fidelity="corrected"):
    """Assemble A, f, H_F and the H_m family; factor with SuperLU."""
    omega, h, eta, c_full, f_grid = _cpu_problem(n, b, wave_num, alpha,
                                                 problem)
    A = fd_stencil.build_a_stencil(n, b, const, eta, omega, h, c_full,
                                   fidelity=fidelity,
                                   complex_dtype=torch.complex128)
    hm = fd_stencil.build_hm_stencils(n, b, const, eta, omega, h, c_full,
                                      fidelity=fidelity,
                                      complex_dtype=torch.complex128)
    HF = fd_stencil.extract_hf_stencil(A, b, full_coupling=True)

    lu_HF = spla.splu(_strip_to_csc(_fields(HF, _FIELDS5)))
    hm_np = _fields(hm, _FIELDS5)
    lus = [spla.splu(_strip_to_csc({k: v[mi] for k, v in hm_np.items()}))
           for mi in range(n - b)]
    a_np = _fields(A, _FIELDS5)
    f_vec = f_grid.numpy().reshape(-1)
    A_sp = _strip_to_csc(a_np).tocsr()
    return A_sp, f_vec, lu_HF, lus, a_np["cs"], a_np["cn"]


def make_apply(n, b, lu_HF, lus, a_cs, a_cn):
    """The corrected Algorithm 2.4 sweep (D2 replace, D3 full H_F) as a
    flat-vector callable: complex128, SuperLU subgrid solves."""
    L = n

    def corner_solve(k, v):
        """(H_{b+1+k}^{-1} [0; ...; 0; v])[last n]: one subgrid solve."""
        rhs = np.zeros(b * n, np.complex128)
        rhs[-n:] = v
        return lus[k].solve(rhs)[-n:]

    def apply_m(f_vec):
        u = f_vec.reshape(L, n).astype(np.complex128).copy()
        TFuF = lu_HF.solve(u[:b].reshape(-1)).reshape(b, n)
        u[b] -= a_cs[b] * TFuF[b - 1]
        for j in range(b + 1, L):                      # forward sweep
            u[j] -= a_cs[j] * corner_solve(j - 1 - b, u[j - 1])
        for j in range(L - 1, b - 1, -1):              # diag+backward fused
            rhs = u[j] - (a_cn[j] * u[j + 1] if j < L - 1 else 0.0)
            u[j] = corner_solve(j - b, rhs)
        rhs_f = np.zeros((b, n), np.complex128)
        rhs_f[b - 1] = a_cn[b - 1] * u[b]
        u[:b] = TFuF - lu_HF.solve(rhs_f.reshape(-1)).reshape(b, n)
        return u.reshape(-1)

    return apply_m


def _strip9_to_csc(S):
    """(L, n) Stencil9 fields -> scipy CSC with offsets 0, +-1, +-n,
    +-(n-1), +-(n+1).  The assembly's edge masks (csw[:,0] = csw[0,:] = 0
    and so on) zero exactly the entries that would otherwise wrap across
    row boundaries in the flat indexing, the invariant the 5-point
    conversion `_strip_to_csc` relies on for its +-1 offsets."""
    f = {k: v.reshape(-1) for k, v in _fields(S, _FIELDS9).items()}
    nn = S.cc.shape[-1]
    return sp.diags(
        [f["cc"], f["cw"][1:], f["ce"][:-1], f["cs"][nn:], f["cn"][:-nn],
         f["csw"][nn + 1:], f["cse"][nn - 1:],
         f["cnw"][:-(nn - 1)], f["cne"][:-(nn + 1)]],
        [0, -1, 1, -nn, nn, -(nn + 1), -(nn - 1), nn - 1, nn + 1],
        format="csc")


def _setup_scipy9(n, b, wave_num, const, alpha, gamma=2.0 / 3.0,
                  problem="c1_f1", fidelity="corrected"):
    """9-point assembly + SuperLU factorization of H_F9 and the H_m9
    family: the independent complex128 oracle for the 9-point solver
    (`precond.sweeping9` is a different lineage, the batched
    tridiagonal-coupling Schur recursion; here every subgrid is a SuperLU
    solve, the reference's algorithm 2.3 pattern)."""
    omega, h, eta, c_full, f_grid = _cpu_problem(n, b, wave_num, alpha,
                                                 problem)
    kw = dict(gamma=gamma, fidelity=fidelity, complex_dtype=torch.complex128)
    A9 = fd_stencil.build_a_stencil9(n, b, const, eta, omega, h, c_full,
                                     **kw)
    hm9 = fd_stencil.build_hm_stencils9(n, b, const, eta, omega, h, c_full,
                                        **kw)
    HF9 = fd_stencil.extract_hf_stencil9(A9, b)

    lu_HF = spla.splu(_strip9_to_csc(HF9))
    lus = [spla.splu(_strip9_to_csc(hm9.map(lambda f: f[mi])))
           for mi in range(n - b)]
    a9 = _fields(A9, _FIELDS9)
    a_lo = (a9["csw"], a9["cs"], a9["cse"])       # each (L, n)
    a_up = (a9["cnw"], a9["cn"], a9["cne"])
    # the compact scheme solves A9 u = M f (the Mehrstellen right-hand-side
    # filter, as the driver's path does)
    f_flt = fd_stencil.mass_filter9(n, b, const, eta, omega, h, f_grid)
    f_vec = f_flt.numpy().reshape(-1)
    A_sp = _strip9_to_csc(A9).tocsr()
    return A_sp, f_vec, lu_HF, lus, a_lo, a_up


def make_apply9(n, b, lu_HF, lus, a_lo, a_up):
    """The 9-point Algorithm 2.4 sweep (tridiagonal inter-layer coupling
    applications) as a flat-vector callable: complex128, SuperLU subgrid
    solves, independent of `precond.sweeping9`."""
    L = n

    def trimv(t, j, v):
        sub, dia, sup = (c[j] for c in t)
        y = dia * v
        y[1:] += sub[1:] * v[:-1]
        y[:-1] += sup[:-1] * v[1:]
        return y

    def corner_solve(k, v):
        rhs = np.zeros(b * n, np.complex128)
        rhs[-n:] = v
        return lus[k].solve(rhs)[-n:]

    def apply_m(f_vec):
        u = f_vec.reshape(L, n).astype(np.complex128).copy()
        TFuF = lu_HF.solve(u[:b].reshape(-1)).reshape(b, n)
        u[b] -= trimv(a_lo, b, TFuF[b - 1])
        for j in range(b + 1, L):                      # forward sweep
            u[j] -= trimv(a_lo, j, corner_solve(j - 1 - b, u[j - 1]))
        for j in range(L - 1, b - 1, -1):              # diag+backward fused
            rhs = u[j] - (trimv(a_up, j, u[j + 1]) if j < L - 1 else 0.0)
            u[j] = corner_solve(j - b, rhs)
        rhs_f = np.zeros((b, n), np.complex128)
        rhs_f[b - 1] = trimv(a_up, b - 1, u[b])
        u[:b] = TFuF - lu_HF.solve(rhs_f.reshape(-1)).reshape(b, n)
        return u.reshape(-1)

    return apply_m


def _gmres_records(A_sp, f_vec, apply_m, *, prefix, fields, impl, rtols,
                   restart, maxiter, setup_s):
    """scipy GMRES with the sweep as M, one record per tolerance."""
    M = spla.LinearOperator(A_sp.shape, matvec=apply_m, dtype=np.complex128)
    out = []
    for rtol in rtols:
        iters = 0

        def cb(_pr_norm):
            nonlocal iters
            iters += 1

        t0 = time.time()
        x, info = spla.gmres(A_sp, f_vec, M=M, rtol=rtol, atol=0.0,
                             restart=restart, maxiter=maxiter // restart,
                             callback=cb, callback_type="pr_norm")
        solve_s = time.time() - t0
        true_res = float(np.linalg.norm(A_sp @ x - f_vec)
                         / np.linalg.norm(f_vec))
        rec = {"metric": f"{prefix}_rtol{rtol:g}", **fields, "rtol": rtol,
               "iters": iters, "info": int(info), "true_residual": true_res,
               "setup_s": round(setup_s, 1), "solve_s": round(solve_s, 1),
               "dtype": "complex128", "impl": impl}
        out.append(rec)
        print(json.dumps(rec), flush=True)
    return out


def run_oracle9(n, b=None, wave_num=None, const=60.0, alpha=2.0,
                gamma=2.0 / 3.0, rtols=(1e-3,), restart=20, maxiter=200):
    """9-point oracle record(s): scipy GMRES + the SuperLU 9-point sweep.

    Defaults follow the 9-point recipe (`precond.sweeping9`): b ~ n/14
    (at least 12), C ~ 60."""
    wave_num = wave_num if wave_num is not None else (n + 1) / 8.0
    if b is None:
        b = max(12, -(-n // 14))
    t0 = time.time()
    A_sp, f_vec, lu_HF, lus, a_lo, a_up = _setup_scipy9(
        n, b, wave_num, const, alpha, gamma)
    setup_s = time.time() - t0
    return _gmres_records(
        A_sp, f_vec, make_apply9(n, b, lu_HF, lus, a_lo, a_up),
        prefix=f"oracle9_iters_n{n}",
        fields={"n": n, "b": b, "stencil": "9pt", "stencil_gamma": gamma,
                "wave_num": wave_num, "const": const},
        impl="scipy-superlu-9pt", rtols=rtols, restart=restart,
        maxiter=maxiter, setup_s=setup_s)


def run_oracle(n, b=12, wave_num=None, const=None, alpha=2.0,
               rtols=(1e-3, 1e-6), restart=20, maxiter=200):
    """5-point oracle record(s): scipy GMRES + the SuperLU corrected
    sweep, with the reference's tuned defaults for c1_f1."""
    wave_num = wave_num if wave_num is not None else (n + 1) / 8.0
    default_C = {127: 81.0, 255: 62.0, 511: 81.0, 1023: 100.0}
    const = const if const is not None else default_C.get(n, 81.0)
    t0 = time.time()
    A_sp, f_vec, lu_HF, lus, a_cs, a_cn = _setup_scipy(
        n, b, wave_num, const, alpha)
    setup_s = time.time() - t0
    return _gmres_records(
        A_sp, f_vec, make_apply(n, b, lu_HF, lus, a_cs, a_cn),
        prefix=f"oracle_iters_n{n}",
        fields={"n": n, "b": b, "wave_num": wave_num, "const": const},
        impl="scipy-superlu-corrected", rtols=rtols, restart=restart,
        maxiter=maxiter, setup_s=setup_s)


def main(argv=None):
    ap = argparse.ArgumentParser(prog="helmholtz_tpu_torch.bench.ref_oracle")
    ap.add_argument("--n", type=int, default=1023)
    ap.add_argument("--b", type=int, default=None)
    ap.add_argument("--wave-num", type=float, default=None)
    ap.add_argument("--const", type=float, default=None)
    ap.add_argument("--rtols", type=float, nargs="+", default=[1e-3, 1e-6])
    ap.add_argument("--stencil", default="5pt", choices=["5pt", "9pt"])
    ap.add_argument("--gamma", type=float, default=2.0 / 3.0)
    args = ap.parse_args(argv)
    if args.stencil == "9pt":
        run_oracle9(args.n, args.b, args.wave_num,
                    args.const if args.const is not None else 60.0,
                    gamma=args.gamma, rtols=args.rtols)
    else:
        run_oracle(args.n, args.b if args.b is not None else 12,
                   args.wave_num, args.const, rtols=args.rtols)
    return 0


if __name__ == "__main__":
    sys.exit(main())
