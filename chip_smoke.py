#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA H100.

    python3 chip_smoke.py

Builds the CUDA kernels from the sources in this checkout, holds each kernel
variant against its plain PyTorch version at the shapes of the paths below,
runs one small solve with a known iteration count and then, through the
normal entry points at full width (n = 1023, b = 12, c1_f1, bf16 G,
complex64):

  solve       run_solver, omega/2pi = 128, C = 100, rtol 1e-3;
  multisolve  run_multisolve, two frequencies x four sources, dense G;
  amortized   run_multisolve, five frequencies x four sources, compressed G,
              an anchor factorization every fourth frequency;
  precision   run_solver at rtol 1e-6 with precision="ir-df32" and one
              preconditioner refinement;

then the 9-point scheme (stencil="9pt", b = 74, C = 60; the sweeps take
the kernel's tridiagonal-coupling variants, the operator product is plain
tensor code):

  solve9_small  run_solver at n = 511, the one 9-point size with a known
                count at this shape;
  solve9        run_solver at n = 1023, rtol 1e-3;
  multisolve9   run_multisolve, three frequencies x four sources, compressed
                G, an anchor factorization every second frequency;
  precision9    run_solver at n = 511, rtol 1e-6, precision="ir-df32";

and the exact path:

  exact         run_solver at n = 511 with precond="exact" (511 layer
                inverses, a 1.07 GB stack);
  exact_residual  its residual recomputed on the card through the
                block-sparse product (BSR) of the operator, `bsr_matvec`,
                and held against the stencil product;

After `solve` it profiles one apply of the main path's preconditioner
with torch.profiler (`apply_profile`: K2's share of the device time, the
device's idle share).  It checks by launch counts, set to zero before each
path and read after it, that each path went through its kernel variants.
Every factoring path runs its batched inverses through the blocked
Gauss-Jordan inverse and its panel kernel.  Any failed phase ends the
script with a non-zero exit code; it needs a CUDA device and exits with
code 1 without one.

Every phase prints one JSON line.  The last three lines are the kernel
table, the card's name and power limit, and the verdict.
"""
import argparse
import dataclasses
import itertools
import json
import math
import os
import sys
import time
import warnings

import numpy as np
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops import dense
from helmholtz_tpu_torch.ops import spmv as plain_spmv
from helmholtz_tpu_torch.ops.kernels import build
from helmholtz_tpu_torch.ops.kernels import bsr_spmm as k4
from helmholtz_tpu_torch.ops.kernels import gj_inverse as k3
from helmholtz_tpu_torch.ops.kernels import spmv_stencil as k1
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.ops.sparse_algebra import stencil_to_bsr
from helmholtz_tpu_torch.precond import sweeping, sweeping9
from helmholtz_tpu_torch.scripts.common import (
    card, gj_matrices, lerp_tables, randc, random_g, rel_err, schur_blocks,
    sweep_inputs, time_ms)

# Published peaks of one H100 SXM at its full power limit: device memory
# rate and the float32 rate outside the tensor cores (every kernel does
# float32 FMA on CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

FULL = dict(n=1023, b=12, wave_num=128.0, const=100.0, problem="c1_f1",
            rtol=1e-3, restart=20, maxiter=60, g_dtype="bf16")
SMALL = dict(n=127, b=12, wave_num=16.0, const=81.0, problem="c1_f1",
             rtol=1e-3, g_dtype="f32", factor_stride=1)
# The 9-point path at full width: the reference package's measured
# configuration (its bench's `ninepoint` block; b ~ n / 14, C = 60).
NINE = dict(n=1023, b=74, wave_num=128.0, const=60.0, problem="c1_f1",
            stencil="9pt", rtol=1e-3, restart=20, maxiter=60, g_dtype="bf16")
ORACLE_ITERS_FULL = 5       # complex128 scipy oracle, ORACLE.json
ORACLE_ITERS_SMALL = 2

# The batched paths: the configurations of MULTISOLVE_n1023.jsonl and of
# the first five rows of MULTISOLVE_AMORTIZED_n1023.jsonl, whose reference
# runs needed at most 5 iterations a source.
MULTI = dict(wave_nums=[128.0, 64.0], consts=[100.0, 81.0], n_sources=4,
             rtol=1e-3, g_dtype="bf16")
AMORTIZED = dict(wave_nums=[126.0, 126.5, 127.0, 127.5, 128.0],
                 consts=[100.0], n_sources=4, rtol=1e-3, g_dtype="bf16",
                 factor_stride=7, g_compress=True, freq_anchor_every=4)
MAX_ITERS_BATCHED = 6       # the reference's largest count + 1
# rtol 1e-6: the reference took 6 iterations, the complex128 oracle 8
PRECISE = dict(n=1023, b=12, wave_num=128.0, const=100.0, problem="c1_f1",
               rtol=1e-6, precision="ir-df32", precond_refine=1,
               g_dtype="bf16", maxiter=60)
MAX_ITERS_PRECISE = 9       # oracle + 1
LERP_STRIDE = 7             # the auto stride at n = 1023

# The 9-point paths.  n = 511 is the one size with a complex128 oracle count
# at this shape (ORACLE.json, oracle9_iters_n511_*: 4 at rtol 1e-3, 6 at
# 1e-6); at n = 1023 the reference package's own run took 4 iterations
# (BENCH_r05.json, ninepoint) and its batched runs 4-5 (NINEPOINT.jsonl).
NINE_SMALL = dict(NINE, n=511, b=37, wave_num=64.0)
NINE_PRECISE = dict(NINE_SMALL, rtol=1e-6, precision="ir-df32",
                    precond_refine=1)
NINE_MULTI = dict(wave_nums=[128.0, 127.5, 127.0], consts=[60.0],
                  n_sources=4, rtol=1e-3, stencil="9pt", g_dtype="bf16",
                  factor_stride=7, g_compress=True, freq_anchor_every=2)
MAX_ITERS_NINE = 5            # oracle / reference count + 1
MAX_ITERS_NINE_PRECISE = 7    # oracle + 1
APPLY9 = dict(n=255, b=19, wave_num=32.0, const=60.0)   # oracle9_iters_n255

# The exact path: ORACLE.json's n = 511 5-point configuration, uncut.  The
# exact factorization is a perfect preconditioner: at most 2 iterations, the
# bound the reference package's own test pins for it.
EXACT = dict(n=511, b=12, wave_num=64.0, const=81.0, problem="c1_f1",
             precond="exact", rtol=1e-3)
MAX_ITERS_EXACT = 2

# K3 at the batches of the paths (1: the exact path's layer inverses and
# H_F's; 146: the samples of the n = 1023 setup; 1000: a larger chunk) and
# panel widths 33 (odd), 64 (the blocked inverse's base case at every size
# used) and 128 (the kernel's largest)
K3_BATCHES = (1, 146, 1000)
K3_WIDTHS = (33, 64, 128)
K3_MAIN = (146, 64)          # the shape timed for the kernel table
K4_WIDTHS = (1, 4, 16)       # columns of X on the n = 511 operator

# Tolerances, relative to the largest entry of the plain version's result;
# both were tightened to about ten times what the H100 showed.
K1_TOL = 2e-6    # five float32 FMAs in another order (observed 1.5e-7)
K2_TOL = 5e-6    # float32 row sums of n terms in another order, carried
                 # through up to n - b steps (observed up to 4.0e-7)
K3_TOL = 1e-5    # k float32 rank-1 steps in another order, reciprocal
                 # times row in place of a division, on matrices of
                 # condition number about 3 (observed up to 2.8e-6 at k=128)
K4_TOL = 5e-6    # float32 sums of bn products in another order (observed
                 # up to 5.1e-7)
INV_TOL = 1e-5   # ||X A - I|| / ||I|| of a full-float32 inverse of the
                 # n = 1023 Schur blocks (observed 7.6e-7 for the blocked
                 # Gauss-Jordan route, 4.2e-7 for pivoted LU; a panel
                 # product in TF32 would round near 5e-4)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(json.dumps({"ok": False, "error": msg}), flush=True)
    sys.exit(1)


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


# -- K1 -----------------------------------------------------------------------

def csr_of(A):
    """The stencil as a torch sparse CSR matrix: the library yardstick."""
    L, n = A.grid_shape
    dev = A.device
    k = torch.arange(L * n, device=dev)
    i, j = k % n, k // n
    parts = [(A.cc, 0, torch.ones_like(k, dtype=torch.bool)),
             (A.cw, -1, i > 0), (A.ce, 1, i < n - 1),
             (A.cs, -n, j > 0), (A.cn, n, j < L - 1)]
    rows = torch.cat([k[m] for _, _, m in parts])
    cols = torch.cat([k[m] + off for _, off, m in parts])
    vals = torch.cat([f.reshape(-1)[m] for f, _, m in parts])
    coo = torch.sparse_coo_tensor(torch.stack([rows, cols]), vals,
                                  (L * n, L * n)).coalesce()
    return coo.to_sparse_csr()


def check_k1(A, gen, flush, timed):
    L, n = A.grid_shape
    u = randc((L, n), gen, A.device)
    got = k1.stencil_matvec(A, u)
    torch.cuda.synchronize()
    ref = plain_spmv.stencil_matvec(A, u)
    err, rel = rel_err(got, ref)
    if not rel <= K1_TOL:
        fail(f"stencil_matvec n={n}: relative error {rel:.3e} > {K1_TOL}")
    rec = {"n": n, "max_abs_err": err, "rel_err": rel, "tol": K1_TOL}
    if timed:
        points = L * n
        rec["bound_ms"], rec["bound_by"] = bound(7 * 8 * points, 40 * points)
        rec["ms"] = time_ms(lambda: k1.stencil_matvec(A, u), 20, flush)
        rec["plain_ms"] = time_ms(lambda: plain_spmv.stencil_matvec(A, u),
                                  5, flush)
        A_csr = csr_of(A)
        x = u.reshape(-1)
        lib = A_csr @ x
        _, lib_rel = rel_err(lib.reshape(L, n), ref)
        if not lib_rel <= 1e-5:
            fail(f"the CSR yardstick disagrees: {lib_rel:.3e}")
        rec["library_ms"] = time_ms(lambda: A_csr @ x, 10, flush)
        rec["library"] = "torch sparse CSR @ vector"
    return rec


# -- K2 -----------------------------------------------------------------------


def variant_name(mode, bf16, shared=False, lerp=False, R=None, tri=False):
    return (f"sweep_{mode}[{'bf16' if bf16 else 'f32'}"
            f"{',shared' if shared else ''}{',lerp' if lerp else ''}"
            f"{',tri' if tri else ''}{f',R{R}' if R else ''}]")


def check_k2(G_re, G_im, mode, gen, timed, rows=None, library_step=False,
             R=None, tables=None, tri=False):
    """One sweep over `rows` grid rows (default: one per panel, or one per
    entry of the lerp tables) through the kernel and through the plain loop,
    for R right-hand sides (None: the unbatched call), with diagonal or
    (`tri`) tridiagonal coupling."""
    Mg, n, _ = G_re.shape
    dev = G_re.device
    lerp = tables is not None
    shared = Mg == 1 and not lerp
    rows = rows or (tables[0].shape[0] if lerp else Mg)
    S = rows - 1 if mode == "fwd" else rows
    kw = dict(mode=mode)
    if lerp:
        kw.update(g_lo=tables[0], g_w=tables[1])
    u, c, carry0 = sweep_inputs(n, S, R, gen, dev, tri)
    k2.reset_counts()
    got = k2.sweep(G_re, G_im, u, c, carry0, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = k2.plain_sweep(G_re, G_im, u, c, carry0, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = rel_err(got, ref)
    name = variant_name(mode, G_re.dtype == torch.bfloat16, shared, lerp, R,
                        tri)
    if not (rel <= K2_TOL and math.isfinite(rel)):
        fail(f"{name} n={n}: relative error {rel:.3e} > {K2_TOL}")
    rec = {"name": name, "n": n, "steps": S, "max_abs_err": err,
           "rel_err": rel, "tol": K2_TOL}
    if timed:
        width = R or 1
        panel_bytes = n * n * 2 * G_re.element_size()
        # every input read once, the output written once: u and out per
        # right-hand side, c (one row a step, or three), carry0; of G the
        # panels this sweep uses (all samples of a compressed stack, each
        # ONCE)
        c_rows = 3 if tri else 1
        vec_bytes = ((2 * width + c_rows) * S + width) * n * 8
        panels = Mg if lerp else 1 if shared else S
        table_bytes = 12 * S if lerp else 0
        # the function of a lerp step is (w0 G[lo] + w1 G[lo+1]) @ V: the
        # two panels combined once (3 operations an entry of each plane)
        # and ONE product, whatever arithmetic the kernel chooses
        flops = ((8 * width + (6 if lerp else 0)) * n * n
                 + (24 * width * n if tri else 0)) * S
        rec["bound_ms"], rec["bound_by"] = bound(
            panels * panel_bytes + vec_bytes + table_bytes, flops)
        if lerp:
            # what the device memory would carry with no reuse of a panel
            # between steps: two panels a step
            rec["bound_no_reuse_ms"], _ = bound(
                2 * S * panel_bytes + vec_bytes + table_bytes, flops)
        k2.reset_counts()
        rec["ms"] = time_ms(
            lambda: k2.sweep(G_re, G_im, u, c, carry0, **kw), 3)
        rec["plain_ms"] = plain_ms
        rec["library_ms"] = None
        rec["step_ms"] = rec["ms"] / S
    # the plan of each launch that the wrapper made in the (timed) call,
    # one a chunk of at most MAX_WIDTH right-hand sides, as it recorded it
    rec["plans"] = [{"width": key[1], **dataclasses.asdict(plan)}
                    for key, plan in k2.plans_by_variant.items()]
    if library_step:
        # one step's product as one library call: torch.mv of a complex64
        # panel (torch.mm with an (n, R) block for R right-hand sides), over
        # enough distinct panels to stay out of the L2 cache
        P = min(Mg, 64)
        Gc = torch.complex(G_re[:P, :, :n].float(),
                           G_im[:P, :, :n].float())
        v = carry0 if R is None else carry0.T.contiguous()
        op = torch.mv if R is None else torch.mm
        state = {"k": 0}

        def one():
            op(Gc[state["k"] % P], v)
            state["k"] += 1

        rec["step_library_ms"] = time_ms(
            lambda: [one() for _ in range(P)], 3) / P
        rec["step_library"] = (
            "torch.mv on a complex64 panel" if R is None else
            f"torch.mm of a complex64 panel with an (n, {R}) block")
    return rec


# -- K3 -----------------------------------------------------------------------


def check_k3(B, k, gen, flush, timed):
    A = gj_matrices(B, k, gen, flush.device)
    got = k3.gj_inverse(A)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = k3.gauss_jordan_inverse_unpivoted(A)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = rel_err(got, ref)
    if not (rel <= K3_TOL and math.isfinite(rel)):
        fail(f"gj_inverse ({B}, {k}, {k}): relative error {rel:.3e} > "
             f"{K3_TOL}")
    rec = {"batch": B, "k": k, "max_abs_err": err, "rel_err": rel,
           "tol": K3_TOL}
    if timed:
        rec["bound_ms"], rec["bound_by"] = bound(16 * k * k * B,
                                                 8 * k ** 3 * B)
        rec["ms"] = time_ms(lambda: k3.gj_inverse(A), 10, flush)
        rec["plain_ms"] = plain_ms
        rec["library_ms"] = time_ms(lambda: torch.linalg.inv(A), 10, flush)
        rec["library"] = "torch.linalg.inv on the same batch"
    return rec


def inverse_residual(X, A):
    """||X A - I||_F / ||I||_F over a batch, one matrix at a time."""
    n = A.shape[-1]
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    sq = sum(torch.linalg.matrix_norm(X[i] @ A[i] - eye).item() ** 2
             for i in range(A.shape[0]))
    return math.sqrt(sq / (A.shape[0] * n))


def check_blocked_inverse(flush):
    """The setup's batched inverse at its main shape, both routes, and at a
    batch of one (one Schur block: what the lerped setups' H_F and the
    exact path's layer inverses pay)."""
    n = FULL["n"]
    Mg = n - FULL["b"]
    B = len(sweeping.sample_positions(Mg, LERP_STRIDE))
    S = schur_blocks(FULL, LERP_STRIDE, B)
    rec = {"batch": B, "n": n, "tol": INV_TOL}
    for route, pivoted in (("gauss_jordan", False), ("linalg_inv", True)):
        X = dense.batched_inverse(S, pivoted=pivoted)
        torch.cuda.synchronize()
        rec[f"{route}_residual"] = inverse_residual(X, S)
        del X
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        base = torch.cuda.memory_allocated()
        rec[f"{route}_ms_per_inverse"] = time_ms(
            lambda: dense.batched_inverse(S, pivoted=pivoted), 3, flush) / B
        rec[f"{route}_workspace_bytes"] = (torch.cuda.max_memory_allocated()
                                           - base)
        # the operations of one inverse, 8 n^3, at the achieved rate
        rec[f"{route}_tflops"] = 8 * n ** 3 / (
            rec[f"{route}_ms_per_inverse"] * 1e-3) / 1e12
        one = S[:1].contiguous()
        rec[f"{route}_batch1_residual"] = inverse_residual(
            dense.batched_inverse(one, pivoted=pivoted), one)
        rec[f"{route}_batch1_ms"] = time_ms(
            lambda: dense.batched_inverse(one, pivoted=pivoted), 5, flush)
    for route, key in itertools.product(("gauss_jordan", "linalg_inv"),
                                        ("residual", "batch1_residual")):
        if not rec[f"{route}_{key}"] < INV_TOL:
            fail(f"blocked_inverse: {route} {key} "
                 f"{rec[f'{route}_{key}']:.3e} >= {INV_TOL}")
    return rec


def profile_apply():
    """One apply of the main path's preconditioner (FULL: n = 1023, bf16 G,
    stride 7) under torch.profiler after a warm-up apply: device time by
    kernel, K2's share of it, and the device's idle share of the window
    timed by CUDA events around the apply.  One stream, so the busy time is
    the sum of the kernels' times."""
    cfg = ht.HelmholtzConfig(n=FULL["n"], b=FULL["b"],
                             wave_num=FULL["wave_num"], const=FULL["const"])
    prob = ht.assemble_problem(cfg, FULL["problem"])
    hm = fd_stencil.build_hm_stencils(cfg.n, cfg.b, cfg.const, cfg.eta,
                                      cfg.omega, cfg.h, prob.c_full,
                                      fidelity="corrected",
                                      complex_dtype=torch.complex64)
    P = sweeping.setup_preconditioner(prob.A, hm, cfg.b,
                                      g_dtype=torch.bfloat16,
                                      factor_stride=LERP_STRIDE)
    del hm
    f = prob.f_grid
    sweeping.apply_preconditioner(P, f)
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        start.record()
        sweeping.apply_preconditioner(P, f)
        end.record()
        torch.cuda.synchronize()
    window_ms = start.elapsed_time(end)
    by_name = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            by_name[e.name] = (by_name.get(e.name, 0.0)
                               + e.time_range.elapsed_us() / 1e3)
    busy_ms = sum(by_name.values())
    sweep_ms = sum(t for name, t in by_name.items() if "sweep_kernel" in name)
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:8]
    return {"window_ms": window_ms, "device_kernels": len(by_name),
            "device_busy_ms": busy_ms,
            "sweep_ms": sweep_ms,
            "sweep_share_of_device": sweep_ms / busy_ms if busy_ms else None,
            "idle_share": 1.0 - busy_ms / window_ms if busy_ms else None,
            "top_kernels_ms": [[name[:120], t] for name, t in top]}


# -- K4 -----------------------------------------------------------------------

def bsr_as_csr(A):
    """The stored entries of a BSR matrix, explicit zeros included, as a
    torch sparse CSR matrix: the library yardstick."""
    bm, bn = A.blocksize
    ip = A.indptr.tolist()
    vals, cols, lens = [], [], []
    for i in range(len(ip) - 1):
        blk = A.data[ip[i]:ip[i + 1]]                 # (c, bm, bn)
        c = blk.shape[0]
        vals.append(blk.transpose(0, 1).reshape(-1))
        cc = (A.indices[ip[i]:ip[i + 1], None].long() * bn
              + torch.arange(bn, device=A.device)).reshape(-1)
        cols.append(cc.expand(bm, c * bn).reshape(-1))
        lens.append(torch.full((bm,), c * bn, device=A.device))
    crow = torch.cat([torch.zeros(1, dtype=torch.int64, device=A.device),
                      torch.cat(lens).cumsum(0)])
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")      # "sparse CSR support is beta"
        return torch.sparse_csr_tensor(crow.int(), torch.cat(cols).int(),
                                       torch.cat(vals), A.shape)


def random_bsr(nbr, nbc, bm, bn, gen, dev):
    """A random complex64 BSR matrix with about 40% of its blocks stored and
    block row 3 empty."""
    rng = np.random.default_rng(int(torch.randint(1 << 30, (1,),
                                                  generator=gen, device=dev)))
    keep = rng.random((nbr, nbc)) < 0.4
    keep[3, :] = False
    keep[0, 0] = True
    br, bc = np.nonzero(keep)
    data = randc((br.shape[0], bm, bn), gen, dev)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    return ht.BSR(data, torch.as_tensor(bc, dtype=torch.int32, device=dev),
                  torch.as_tensor(indptr, dtype=torch.int32, device=dev),
                  (nbr * bm, nbc * bn), (bm, bn))


def check_k4(A, K, gen, flush, timed, library=None):
    X = randc((A.shape[1], K), gen, A.device)
    got = k4.bsr_matmat(A, X)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = k4.plain_bsr_matmat(A, X)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = rel_err(got, ref)
    bm, bn = A.blocksize
    what = f"bsr_matmat blocks {A.data.shape[0]} x ({bm}, {bn}), K={K}"
    if not (rel <= K4_TOL and math.isfinite(rel)):
        fail(f"{what}: relative error {rel:.3e} > {K4_TOL}")
    rec = {"nblocks": A.data.shape[0], "blocksize": [bm, bn], "K": K,
           "max_abs_err": err, "rel_err": rel, "tol": K4_TOL}
    if timed:
        stored = A.data.numel()
        rec["bound_ms"], rec["bound_by"] = bound(
            8 * (stored + A.shape[1] * K + A.shape[0] * K)
            + 4 * (A.data.shape[0] + A.indptr.shape[0]),
            8 * stored * K)
        rec["ms"] = time_ms(lambda: k4.bsr_matmat(A, X), 5, flush)
        rec["plain_ms"] = plain_ms
        rec["library_ms"] = None
        if library is not None:
            rec["library"] = "torch sparse CSR (stored entries) @ X"
            try:
                lib = library @ X
            except RuntimeError as e:      # a yardstick only: record why
                rec["library_error"] = str(e)[:300]
                return rec
            _, lib_rel = rel_err(lib, ref)
            if not lib_rel <= 1e-4:
                fail(f"the CSR yardstick disagrees: {lib_rel:.3e}")
            rec["library_ms"] = time_ms(lambda: library @ X, 5, flush)
    return rec


# -- solves -------------------------------------------------------------------

def variant_key(mode, width, lerp, tri=False):
    return (f"{mode},R{width}{',lerp' if lerp else ''}"
            f"{',tri' if tri else ''}")


def counted(fn):
    """Run fn() with every launch count set to zero just before and read
    just after; also the peak device memory of the run."""
    for k in (k1, k2, k3, k4):
        k.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    # the sweep wrapper counts by (mode, width, lerp, tri); its totals by
    # mode, by width and with lerp tables are sums over that one count
    counts = {"stencil_matvec": k1.launches, "sweep": k2.launches,
              "gj_inverse": k3.launches, "bsr_matmat": k4.launches, **{
                  f"sweep_{m}": c for m, c in k2.launches_by_mode.items()},
              "sweep_lerp": k2.launches_lerp,
              "sweep_by_width": {str(w): c for w, c
                                 in k2.launches_by_width.items()},
              "sweep_variants": {variant_key(*k): c for k, c
                                 in k2.launches_by_variant.items()}}
    return out, counts, torch.cuda.max_memory_allocated()


def solve_with(cfg):
    return ht.run_solver(cfg["n"], cfg["b"], cfg["wave_num"], cfg["const"],
                         **{k: v for k, v in cfg.items()
                            if k not in ("n", "b", "wave_num", "const")})


def counted_solve(cfg):
    return counted(lambda: solve_with(cfg))


def batched_launches(iteration_lists, lerp, restart=20, tri=False):
    """Launches that the lockstep batched GMRES makes for these per-source
    iteration counts, one list per frequency, when every source converges
    inside its first restart cycle: an apply of the whole batch for M b; at
    inner step j one product per source still iterating and one apply of
    that width; then one product per source and one apply of the whole
    batch for the recomputed residuals.  An apply is one forward and one
    backward sweep of its width."""
    products, variants = 0, {}

    def apply(width):
        for mode in ("fwd", "bwd"):
            key = variant_key(mode, width, lerp, tri)
            variants[key] = variants.get(key, 0) + 1

    for its in iteration_lists:
        if max(its) > restart:
            fail(f"{its}: more than one restart cycle; the launch rule "
                 "does not cover that")
        apply(len(its))
        for j in range(max(its)):
            width = sum(1 for it in its if it > j)
            products += width
            apply(width)
        products += len(its)
        apply(len(its))
    return products, variants


def check_multisolve(name, cfg, recs, counts, peak, lerp, modes=None,
                     tri=False):
    """`tri`: a 9-point sweep, whose operator products launch no kernel and
    whose sweeps take the tridiagonal-coupling variants."""
    say(name, records=[{k: r[k] for k in (
            "wave_num", "const", "iterations", "converged", "true_residuals",
            "init_time_s", "solve_time_s", "g_bytes_at_rest",
            "g_traffic_gb_per_apply", "factor_stride", "g_compress")}
            | ({"setup_mode": r["setup_mode"]} if modes else {})
            for r in recs],
        peak_memory_bytes=peak, launches=counts)
    if len(recs) != len(cfg["wave_nums"]):
        fail(f"{name}: {len(recs)} records")
    if modes and [r["setup_mode"] for r in recs] != modes:
        fail(f"{name}: setup modes {[r['setup_mode'] for r in recs]}")
    for r in recs:
        what = f"{name} at {r['wave_num']}"
        if not all(r["converged"]):
            fail(f"{what}: not converged: {r['converged']}")
        if not all(res < 1e-3 for res in r["true_residuals"]):
            fail(f"{what}: true residuals {r['true_residuals']}")
        if max(r["iterations"]) > MAX_ITERS_BATCHED:
            fail(f"{what}: iterations {r['iterations']} > "
                 f"{MAX_ITERS_BATCHED}")
        if bool(r["g_compress"]) != lerp:
            fail(f"{what}: g_compress is {r['g_compress']}")
    want_k1, want_k2 = batched_launches([r["iterations"] for r in recs], lerp,
                                        tri=tri)
    if tri:
        want_k1 = 0
    if counts["stencil_matvec"] != want_k1:
        fail(f"{name}: {counts['stencil_matvec']} stencil launches, "
             f"{want_k1} implied by the iteration lists")
    if counts["sweep_variants"] != want_k2:
        fail(f"{name}: sweep launches {counts['sweep_variants']}, "
             f"{want_k2} implied by the iteration lists")
    if counts["sweep_lerp"] != (counts["sweep"] if lerp else 0):
        fail(f"{name}: {counts['sweep_lerp']} of {counts['sweep']} sweeps "
             "went through the lerp kernel")
    top = variant_key("bwd", cfg["n_sources"], lerp, tri)
    if counts["sweep_variants"].get(top, 0) < 2:
        fail(f"{name}: the sweeps did not go through {top}")
    check_setup_launches(name, counts)


def check_setup_launches(name, counts):
    """Every factoring path inverts through the blocked Gauss-Jordan
    inverse, so its panel kernel ran; no path but the exact one runs the
    BSR product."""
    if counts["gj_inverse"] < 1:
        fail(f"{name}: the setup launched no Gauss-Jordan kernel")
    if counts["bsr_matmat"] != 0:
        fail(f"{name}: {counts['bsr_matmat']} BSR launches")


def check_solve(name, cfg, rep, counts, peak, max_iters, exact_iters=None,
                residual_below=1e-3, applies_per_call=1):
    """`applies_per_call`: 2 when the preconditioner is refined once."""
    tri = cfg.get("stencil") == "9pt"
    exact = cfg.get("precond") == "exact"
    say(name, iterations=rep.iterations, converged=rep.converged,
        true_residual=rep.true_residual, residual_norm=rep.residual_norm,
        init_time_s=rep.init_time, solve_time_s=rep.solve_time,
        peak_memory_bytes=peak, factor_stride=rep.config["factor_stride"],
        launches=counts, history=[float(h) for h in rep.history])
    restart = cfg.get("restart", 20)
    cycles = max(1, -(-rep.iterations // restart))
    # x0 = 0: one apply for M b, one apply and one product per inner
    # iteration, one of each for every cycle's recomputed residual; an apply
    # is one forward and one backward sweep
    want_k1 = rep.iterations + cycles
    want_apply = rep.iterations + cycles + 1
    if not rep.converged:
        fail(f"{name}: not converged")
    if exact_iters is not None and rep.iterations != exact_iters:
        fail(f"{name}: {rep.iterations} iterations, expected {exact_iters}")
    if rep.iterations > max_iters:
        fail(f"{name}: {rep.iterations} iterations > {max_iters}")
    if not rep.true_residual < residual_below:
        fail(f"{name}: true residual {rep.true_residual:.3e} >= "
             f"{residual_below}")
    if not (np.isfinite(rep.u).all()
            and rep.u.shape == (cfg["n"], cfg["n"])):
        fail(f"{name}: solution not finite or of the wrong shape")
    if cfg.get("precision") == "ir-df32":
        # the refinement loop restarts the inner solve; its launches are
        # bounded below, not counted exactly
        for mode in ("fwd", "bwd"):
            key = variant_key(mode, 1, False, tri)
            if counts["sweep_variants"].get(key, 0) < \
                    applies_per_call * rep.iterations:
                fail(f"{name}: sweep launches {counts['sweep_variants']}")
    else:
        # the 9-point operator product is plain tensor code: no launches
        if counts["stencil_matvec"] != (0 if tri else want_k1):
            fail(f"{name}: {counts['stencil_matvec']} stencil launches, "
                 f"{rep.iterations} iterations")
        for mode in ("fwd", "bwd"):
            # the exact preconditioner is a block solve, not a sweep
            if counts[f"sweep_{mode}"] != (0 if exact else want_apply):
                fail(f"{name}: {counts[f'sweep_{mode}']} {mode} sweeps, "
                     f"{want_apply} implied by {rep.iterations} iterations")
    if counts["sweep_bwd_sub"] != 0:
        fail(f"{name}: the corrected solve ran bwd_sub sweeps")
    wrong = [k for k in counts["sweep_variants"]
             if k.endswith(",tri") != tri]
    if wrong or counts["sweep_lerp"]:
        fail(f"{name}: sweeps through {counts['sweep_variants']}")
    check_setup_launches(name, counts)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--kernels-only", action="store_true",
                        help="build and check the kernels, skip the solves "
                             "(a short first run after a kernel change)")
    parser.add_argument("--out-dir", default="chip_smoke_out",
                        help="where the full record (chip_smoke.json) and "
                             "the compiler's log (build_log.txt) are written")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs one CUDA device", file=sys.stderr)
        sys.exit(1)
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    smi = card()
    kind = torch.cuda.get_device_name(0)
    say("device", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    build.build(force=True)
    build.library()
    os.makedirs(args.out_dir, exist_ok=True)
    with open(os.path.join(args.out_dir, "build_log.txt"), "w") as fh:
        fh.write(build.last_build_log or "")
    say("build", seconds=build.last_build_seconds,
        sources=[s.name for s in build.sources()])

    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    n = FULL["n"]

    # K1 at the main path's operator, and at an odd small size
    variants = []
    cfg_full = ht.HelmholtzConfig(n=n, b=FULL["b"], wave_num=FULL["wave_num"],
                                  const=FULL["const"])
    A_full = ht.assemble_problem(cfg_full, FULL["problem"]).A
    rec_k1 = check_k1(A_full, gen, flush, timed=True)
    cfg_33 = ht.HelmholtzConfig(n=33, b=6, wave_num=2.0, const=20.0)
    rec_k1_small = check_k1(ht.assemble_problem(cfg_33).A, gen, None,
                            timed=False)
    say("kernel", name="stencil_matvec", **rec_k1)
    say("kernel", name="stencil_matvec", **rec_k1_small)
    del A_full

    # K2, one right-hand side: every mode x float32 / bfloat16 G at
    # n = 1023 and one shared-G case.  Then R = 4 on one stream of G: every
    # mode x type with a per-step library yardstick, one shared-G case, and
    # the narrower widths a batch passes through as its members finish.
    Mg = n - FULL["b"]
    G32 = random_g(Mg, n, gen, dev)
    G16 = [g.to(torch.bfloat16) for g in G32]
    shared = [g[:1].contiguous() for g in G32]

    def keep(rec):
        variants.append(rec)
        say("kernel", **rec)

    for planes in (G32, G16):
        for mode in k2.MODES:
            keep(check_k2(*planes, mode, gen, timed=True,
                          library_step=(mode == "bwd")))
    keep(check_k2(*shared, "bwd", gen, timed=True, rows=Mg,
                  library_step=True))
    for planes in (G32, G16):
        for mode in k2.MODES:
            keep(check_k2(*planes, mode, gen, timed=True, R=4,
                          library_step=(mode == "bwd")))
    keep(check_k2(*shared, "bwd", gen, timed=True, rows=Mg, R=4,
                  library_step=True))
    for R in (2, 3):
        for mode in ("fwd", "bwd"):
            keep(check_k2(*G16, mode, gen, timed=True, R=R,
                          library_step=(mode == "bwd")))
    # K2 with tridiagonal coupling at the 9-point path's depth (b = 74: 949
    # sweep rows): every mode x type at R = 1 and R = 4
    Mg9 = n - NINE["b"]
    for planes in (G32, G16):
        for R in (None, 4):
            for mode in k2.MODES:
                keep(check_k2(*(g[:Mg9] for g in planes), mode, gen,
                              timed=True, R=R, tri=True,
                              library_step=(mode == "bwd")))
    del G32, G16, shared
    torch.cuda.empty_cache()

    # K2 lerp: stride-7 sample panels (146 for 1011 sweep rows) with the
    # tables of the compressed setup; every mode x type at R = 1 and R = 4,
    # and the widths between in bf16
    tables = lerp_tables(Mg, LERP_STRIDE, dev)
    S32 = random_g(int(tables[0].max()) + 2, n, gen, dev)
    S16 = [g.to(torch.bfloat16) for g in S32]
    for planes in (S32, S16):
        for R in (None, 4):
            for mode in k2.MODES:
                keep(check_k2(*planes, mode, gen, timed=True, R=R,
                              tables=tables))
    for R in (2, 3):
        for mode in ("fwd", "bwd"):
            keep(check_k2(*S16, mode, gen, timed=True, R=R, tables=tables))
    # tridiagonal coupling over bf16 samples (137 for 949 sweep rows)
    tables9 = lerp_tables(Mg9, LERP_STRIDE, dev)
    S9 = [g[:int(tables9[0].max()) + 2] for g in S16]
    for R in (None, 4, 2, 3):
        for mode in (k2.MODES if R in (None, 4) else ("fwd", "bwd")):
            keep(check_k2(*S9, mode, gen, timed=True, R=R, tables=tables9,
                          tri=True))
    del S32, S16, S9
    torch.cuda.empty_cache()

    # every mode x type x kind of stack again at n = 33, for one, for an odd
    # number (3) and for more right-hand sides than one launch carries (5)
    G32s = random_g(33 - 6, 33, gen, dev)
    tables_s = lerp_tables(33 - 6, 4, dev)
    S32s = random_g(int(tables_s[0].max()) + 2, 33, gen, dev)
    # ... each with diagonal and with tridiagonal coupling
    for R, tri in itertools.product((None, 3, 5), (False, True)):
        for planes in (G32s, [g.to(torch.bfloat16) for g in G32s],
                       [g[:1].contiguous() for g in G32s]):
            for mode in k2.MODES:
                say("kernel", **check_k2(*planes, mode, gen, timed=False,
                                         rows=33 - 6, R=R, tri=tri))
        for planes in (S32s, [g.to(torch.bfloat16) for g in S32s]):
            for mode in k2.MODES:
                say("kernel", **check_k2(*planes, mode, gen, timed=False,
                                         R=R, tables=tables_s, tri=tri))

    # a real factored G at n = 255: the kernel apply against the plain apply
    cfg_255 = ht.HelmholtzConfig(n=255, b=12, wave_num=32.0, const=62.0)
    prob = ht.assemble_problem(cfg_255)
    hm = fd_stencil.build_hm_stencils(255, 12, cfg_255.const, cfg_255.eta,
                                      cfg_255.omega, cfg_255.h, prob.c_full,
                                      fidelity="corrected",
                                      complex_dtype=torch.complex64)
    for g_dtype in (torch.float32, torch.bfloat16):
        for d2 in (True, False):
            P = sweeping.setup_preconditioner(prob.A, hm, 12, g_dtype=g_dtype,
                                              d2_replace=d2)
            got = sweeping.apply_preconditioner(P, prob.f_grid)
            ref = sweeping.apply_preconditioner(P, prob.f_grid, impl="plain")
            err, rel = rel_err(got, ref)
            say("apply", n=255, g_dtype=str(g_dtype), d2_replace=d2,
                max_abs_err=err, rel_err=rel, tol=K2_TOL)
            if not rel <= K2_TOL:
                fail(f"apply n=255 {g_dtype} d2={d2}: {rel:.3e} > {K2_TOL}")
    del prob, hm, P
    torch.cuda.empty_cache()

    # the same for a real factored 9-point preconditioner
    c9 = ht.HelmholtzConfig(n=APPLY9["n"], b=APPLY9["b"],
                            wave_num=APPLY9["wave_num"],
                            const=APPLY9["const"])
    prob = ht.assemble_problem(c9)
    nine_args = (c9.n, c9.b, c9.const, c9.eta, c9.omega, c9.h, prob.c_full)
    nine_kw = dict(fidelity="corrected", complex_dtype=torch.complex64)
    A9 = fd_stencil.build_a_stencil9(*nine_args, **nine_kw)
    hm9 = fd_stencil.build_hm_stencils9(*nine_args, **nine_kw)
    for g_dtype in (torch.float32, torch.bfloat16):
        for d2 in (True, False):
            P = sweeping9.setup_preconditioner9(A9, hm9, c9.b,
                                                g_dtype=g_dtype,
                                                d2_replace=d2)
            k2.reset_counts()
            got = sweeping9.apply_preconditioner9(P, prob.f_grid)
            ref = sweeping9.apply_preconditioner9(P, prob.f_grid,
                                                  impl="plain")
            err, rel = rel_err(got, ref)
            say("apply9", n=c9.n, b=c9.b, g_dtype=str(g_dtype),
                d2_replace=d2, max_abs_err=err, rel_err=rel, tol=K2_TOL,
                launches={variant_key(*k): c for k, c
                          in k2.launches_by_variant.items()})
            if not rel <= K2_TOL:
                fail(f"apply9 n={c9.n} {g_dtype} d2={d2}: {rel:.3e} > "
                     f"{K2_TOL}")
            if sorted(k2.launches_by_variant) != sorted(
                    [("fwd", 1, False, True),
                     ("bwd" if d2 else "bwd_sub", 1, False, True)]):
                fail(f"apply9: launches {k2.launches_by_variant}")
    del prob, A9, hm9, P
    torch.cuda.empty_cache()

    # K3 at every batch x panel width, timed at all of them
    k3_recs = []
    for B, k in itertools.product(K3_BATCHES, K3_WIDTHS):
        k3_recs.append(check_k3(B, k, gen, flush, timed=True))
        say("kernel", name="gj_inverse", **k3_recs[-1])
    rec_k3 = next(r for r in k3_recs if (r["batch"], r["k"]) == K3_MAIN)
    # the blocked inverse that K3 serves, both routes on the same matrices
    rec_inv = check_blocked_inverse(flush)
    say("blocked_inverse", **rec_inv)
    torch.cuda.empty_cache()

    # K4 on the exact path's operator as BSR (n = 511: 1531 blocks of
    # 511 x 511) at 1, 4 and 16 columns, then on random block-sparse
    # matrices with an empty block row, square and ragged block sizes
    cfg_x = ht.HelmholtzConfig(n=EXACT["n"], b=EXACT["b"],
                               wave_num=EXACT["wave_num"],
                               const=EXACT["const"])
    A_bsr = stencil_to_bsr(ht.assemble_problem(cfg_x, EXACT["problem"]).A)
    csr_x = bsr_as_csr(A_bsr)
    k4_recs = []
    for K in K4_WIDTHS:
        k4_recs.append(check_k4(A_bsr, K, gen, flush, timed=True,
                                library=csr_x))
        say("kernel", name="bsr_matmat", **k4_recs[-1])
    rec_k4 = k4_recs[0]
    del A_bsr, csr_x
    torch.cuda.empty_cache()
    for (bm, bn), K in itertools.product(((64, 64), (128, 128), (48, 80)),
                                         (16, 5, 1)):
        A_rand = random_bsr(16, 12, bm, bn, gen, dev)
        k4_recs.append(check_k4(A_rand, K, gen, flush, timed=True,
                                library=bsr_as_csr(A_rand)))
        say("kernel", name="bsr_matmat", **k4_recs[-1])

    if args.kernels_only:
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "kind": kind, "kernels_only": True,
                       "stencil_matvec": rec_k1, "sweep_variants": variants,
                       "gj_inverse": k3_recs, "blocked_inverse": rec_inv,
                       "bsr_matmat": k4_recs}, fh, indent=1)
        say("done", seconds=time.perf_counter() - t_start, kernels_only=True)
        return

    # the tripwire solve, then the main path at full width
    rep, counts, peak = counted_solve(SMALL)
    check_solve("small_solve", SMALL, rep, counts, peak,
                max_iters=ORACLE_ITERS_SMALL, exact_iters=ORACLE_ITERS_SMALL)
    paths = {}
    rep, counts, peak = counted_solve(FULL)
    check_solve("solve", FULL, rep, counts, peak,
                max_iters=ORACLE_ITERS_FULL + 1)
    paths["solve"] = counts
    record = {"solve": rep.metrics(), "solve_peak_bytes": peak}
    record["apply_profile"] = profile_apply()
    say("apply_profile", **record["apply_profile"])
    if not record["apply_profile"]["device_kernels"]:
        say("apply_profile", note="torch.profiler recorded no device time; "
            "the window's CUDA-event time stands alone")
    torch.cuda.empty_cache()

    # many sources and frequencies: dense G, then compressed G with the
    # setup amortized over the frequencies
    for name, cfg, lerp, modes in (
            ("multisolve", MULTI, False, None),
            ("amortized", AMORTIZED, True,
             ["factor"] + ["omega_lerp"] * 3 + ["factor"])):
        kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
        recs, counts, peak = counted(lambda: ht.run_multisolve(
            n, FULL["b"], cfg["wave_nums"], **kw))
        check_multisolve(name, cfg, recs, counts, peak, lerp, modes)
        paths[name] = counts
        record[name] = recs
        record[f"{name}_peak_bytes"] = peak

    # the tight tolerance: refinement in complex128 around the complex64
    # solve, and one refinement step of the preconditioner
    rep, counts, peak = counted_solve(PRECISE)
    check_solve("precision", PRECISE, rep, counts, peak,
                max_iters=MAX_ITERS_PRECISE, residual_below=1e-5,
                applies_per_call=2)
    paths["precision"] = counts
    record["precision"] = rep.metrics()

    # the 9-point scheme: the size with an oracle count, then full width
    for name, cfg, limit, kw in (
            ("solve9_small", NINE_SMALL, MAX_ITERS_NINE, {}),
            ("solve9", NINE, MAX_ITERS_NINE, {}),
            ("precision9", NINE_PRECISE, MAX_ITERS_NINE_PRECISE,
             dict(residual_below=1e-5, applies_per_call=2))):
        rep, counts, peak = counted_solve(cfg)
        check_solve(name, cfg, rep, counts, peak, max_iters=limit, **kw)
        paths[name] = counts
        record[name] = rep.metrics()
        record[f"{name}_peak_bytes"] = peak
    cfg = NINE_MULTI
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    recs, counts, peak = counted(lambda: ht.run_multisolve(
        n, NINE["b"], cfg["wave_nums"], **kw))
    # ascending omega: 127.0 and 128.0 are the anchors, 127.5 lies between
    check_multisolve("multisolve9", cfg, recs, counts, peak, True,
                     ["factor", "omega_lerp", "factor"], tri=True)
    paths["multisolve9"] = counts
    record["multisolve9"] = recs
    record["multisolve9_peak_bytes"] = peak

    # the exact factorization
    rep, counts, peak = counted_solve(EXACT)
    check_solve("exact", EXACT, rep, counts, peak, max_iters=MAX_ITERS_EXACT)
    paths["exact"] = counts
    record["exact"] = rep.metrics()
    record["exact_peak_bytes"] = peak

    # then its residual on the card through the BSR product of the
    # operator (K4, through the package's `bsr_matvec`), held against the
    # stencil product (K1): a path of its own, counted on its own
    def exact_residual():
        prob = ht.assemble_problem(cfg_x, EXACT["problem"])
        A, f = prob.A, prob.f_grid.reshape(-1)
        u = torch.as_tensor(rep.u.reshape(-1), dtype=torch.complex64,
                            device=dev)
        return ht.bsr_matvec(stencil_to_bsr(A), u), \
            k1.stencil_matvec_flat(A, u), f

    (Au_bsr, Au_k1, f), counts, _ = counted(exact_residual)
    err, rel = rel_err(Au_bsr, Au_k1)
    card_residual = ((Au_bsr - f).norm() / f.norm()).item()
    say("exact_residual", bsr_vs_stencil_max_abs_err=err,
        bsr_vs_stencil_rel_err=rel, tol=K4_TOL,
        true_residual_on_card=card_residual, launches=counts)
    if (counts["bsr_matmat"], counts["stencil_matvec"],
            counts["gj_inverse"], counts["sweep"]) != (1, 1, 0, 0):
        fail(f"exact_residual: launches {counts}, want one BSR product "
             "and one stencil product")
    if not rel <= K4_TOL:
        fail(f"exact: the BSR product disagrees with the stencil product: "
             f"{rel:.3e} > {K4_TOL}")
    if not card_residual < EXACT["rtol"]:
        fail(f"exact: residual on the card {card_residual:.3e}")
    paths["exact_residual"] = counts
    record["exact_residual_on_card"] = card_residual
    del Au_bsr, Au_k1, f
    torch.cuda.empty_cache()

    # the kernel table: every kernel variant that a full-width path
    # launched (all with bf16 G and the corrected backward step), with the
    # launches counted during those paths
    by_name = {v["name"]: v for v in variants}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms")
    table = [{
        "name": "stencil_matvec", "route": "cuda",
        "source": "helmholtz_tpu_torch/csrc/spmv_stencil.cu",
        "replaces": "helmholtz_tpu/ops/pallas/spmv_stencil.py:124",
        "launches": sum(c["stencil_matvec"] for c in paths.values()),
        "launches_by_path": {p: c["stencil_matvec"]
                             for p, c in paths.items()},
        **{k: rec_k1[k] for k in keys}}]
    for name, source, replaces, rec, shape in (
            ("gj_inverse", "gj_inverse.cu", "gj_inverse.py:94", rec_k3,
             {"batch": rec_k3["batch"], "k": rec_k3["k"]}),
            ("bsr_matmat", "bsr_spmm.cu", "bsr_spmm.py:102", rec_k4,
             {"nblocks": rec_k4["nblocks"],
              "blocksize": rec_k4["blocksize"], "K": rec_k4["K"]})):
        table.append({
            "name": name, "route": "cuda",
            "source": f"helmholtz_tpu_torch/csrc/{source}",
            "replaces": f"helmholtz_tpu/ops/pallas/{replaces}",
            "launches": sum(c[name] for c in paths.values()),
            "launches_by_path": {p: c[name] for p, c in paths.items()},
            **{k: rec[k] for k in keys}, "timed_at": shape})
    launched = {(key, path): c for path, cs in paths.items()
                for key, c in cs["sweep_variants"].items()}
    for tri, lerp in itertools.product((False, True), (False, True)):
        for width in range(1, k2.MAX_WIDTH + 1):
            for mode in ("fwd", "bwd"):
                key = variant_key(mode, width, lerp, tri)
                by_path = {p: c for (k, p), c in launched.items() if k == key}
                if not by_path:
                    continue
                R = None if width == 1 else width   # width 1: unbatched
                v = by_name[variant_name(mode, True, lerp=lerp, R=R,
                                         tri=tri)]
                plan = next(p for p in v["plans"] if p["width"] == width)
                table.append({
                    "name": v["name"], "route": "cuda",
                    "source": "helmholtz_tpu_torch/csrc/sweep.cu",
                    "replaces": "helmholtz_tpu/ops/pallas/sweep.py:"
                                + ("298" if lerp else "302"),
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    **{k: v[k] for k in keys},
                    "steps_per_launch": v["steps"], "step_ms": v["step_ms"],
                    "blocks": plan["blocks"], "stages": plan["stages"],
                    "shared_bytes": plan["shared_bytes"],
                    "step_library_ms": v.get("step_library_ms"),
                    **({"bound_no_reuse_ms": v["bound_no_reuse_ms"]}
                       if lerp else {})})
    names = {row["name"]: row for row in table}
    for path, wanted in (
            ("solve", ["stencil_matvec", "sweep_fwd[bf16]",
                       "sweep_bwd[bf16]"]),
            ("multisolve", ["stencil_matvec", "sweep_fwd[bf16,R4]",
                            "sweep_bwd[bf16,R4]"]),
            ("amortized", ["stencil_matvec", "sweep_fwd[bf16,lerp,R4]",
                           "sweep_bwd[bf16,lerp,R4]"]),
            ("precision", ["stencil_matvec", "sweep_fwd[bf16]",
                           "sweep_bwd[bf16]"]),
            ("solve9_small", ["sweep_fwd[bf16,tri]", "sweep_bwd[bf16,tri]"]),
            ("solve9", ["sweep_fwd[bf16,tri]", "sweep_bwd[bf16,tri]"]),
            ("precision9", ["sweep_fwd[bf16,tri]", "sweep_bwd[bf16,tri]"]),
            ("multisolve9", ["sweep_fwd[bf16,lerp,tri,R4]",
                             "sweep_bwd[bf16,lerp,tri,R4]"]),
            ("exact", ["stencil_matvec"]),
            ("exact_residual", ["stencil_matvec", "bsr_matmat"])):
        for name in wanted + ([] if path == "exact_residual"
                              else ["gj_inverse"]):
            if names.get(name, {}).get("launches_by_path", {}) \
                    .get(path, 0) < 1:
                fail(f"{name} was not launched by the {path} path")

    seconds = time.perf_counter() - t_start
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"nvidia_smi": smi, "kind": kind, "seconds": seconds,
                   "stencil_matvec": rec_k1, "sweep_variants": variants,
                   "gj_inverse": k3_recs, "blocked_inverse": rec_inv,
                   "bsr_matmat": k4_recs, "kernels": table,
                   "launches": paths, **record}, fh, indent=1)
    say("done", seconds=seconds)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
