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

and checks by launch counts, set to zero before each path and read after it,
that each path went through its kernel variants.  Any failed phase ends the
script with a non-zero exit code; it needs a CUDA device and exits with code
1 without one.

Every phase prints one JSON line.  The last three lines are the kernel
table, the card's name and power limit, and the verdict.
"""
import argparse
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops import spmv as plain_spmv
from helmholtz_tpu_torch.ops.kernels import build
from helmholtz_tpu_torch.ops.kernels import spmv_stencil as k1
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.precond import sweeping

# Published peaks of one H100 SXM at its full power limit: device memory
# rate and the float32 rate outside the tensor cores (both kernels do
# float32 FMA on CUDA cores).
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12

FULL = dict(n=1023, b=12, wave_num=128.0, const=100.0, problem="c1_f1",
            rtol=1e-3, restart=20, maxiter=60, g_dtype="bf16")
SMALL = dict(n=127, b=12, wave_num=16.0, const=81.0, problem="c1_f1",
             rtol=1e-3, g_dtype="f32", factor_stride=1)
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

# Tolerances, relative to the largest entry of the plain version's result;
# both were tightened to about ten times what the H100 showed.
K1_TOL = 2e-6    # five float32 FMAs in another order (observed 1.5e-7)
K2_TOL = 5e-6    # float32 row sums of n terms in another order, carried
                 # through up to n - b steps (observed up to 4.0e-7)


def say(phase, **fields):
    print(json.dumps({"phase": phase, **fields}), flush=True)


def fail(msg):
    print(json.dumps({"ok": False, "error": msg}), flush=True)
    sys.exit(1)


def time_ms(fn, reps, flush=None):
    """Mean device time of fn() in ms by CUDA events; `flush` (a large
    buffer) is rewritten before each run so the L2 cache starts cold."""
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        torch.cuda.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def bound(bytes_moved, flops):
    t_bytes = bytes_moved / PEAK_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def rel_err(got, ref):
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    return err, err / scale


def randc(shape, gen, dev):
    re = torch.randn(shape, generator=gen, device=dev)
    im = torch.randn(shape, generator=gen, device=dev)
    return torch.complex(re, im) / math.sqrt(2.0)


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

def sweep_inputs(n, S, R, gen, dev):
    """u (S, n) or (S, R, n), c (S, n) with its top row zero, carry0."""
    shape = (S, n) if R is None else (S, R, n)
    u = randc(shape, gen, dev)
    c = randc((S, n), gen, dev)
    c[-1] = 0
    return u, c, randc(shape[1:], gen, dev)


def random_g(Mg, n, gen, dev):
    """Random float32 planes at the kernel's pitch, scaled so that a panel's
    spectral norm is about 0.5 (the recursion neither dies nor blows up)."""
    ld = k2.g_ld(n)
    sigma = 0.25 / math.sqrt(n) / math.sqrt(2.0)
    planes = []
    for _ in range(2):
        g = torch.zeros((Mg, n, ld), device=dev)
        g[:, :, :n] = torch.randn((Mg, n, n), generator=gen,
                                  device=dev) * sigma
        planes.append(g)
    return planes


def lerp_tables(M, stride, dev):
    g_w, g_lo = sweeping.compress_tables(M, stride)
    return torch.from_numpy(g_lo).to(dev), torch.from_numpy(g_w).to(dev)


def variant_name(mode, bf16, shared=False, lerp=False, R=None):
    return (f"sweep_{mode}[{'bf16' if bf16 else 'f32'}"
            f"{',shared' if shared else ''}{',lerp' if lerp else ''}"
            f"{f',R{R}' if R else ''}]")


def check_k2(G_re, G_im, mode, gen, timed, rows=None, library_step=False,
             R=None, tables=None):
    """One sweep over `rows` grid rows (default: one per panel, or one per
    entry of the lerp tables) through the kernel and through the plain loop,
    for R right-hand sides (None: the unbatched call)."""
    Mg, n, _ = G_re.shape
    dev = G_re.device
    lerp = tables is not None
    shared = Mg == 1 and not lerp
    rows = rows or (tables[0].shape[0] if lerp else Mg)
    S = rows - 1 if mode == "fwd" else rows
    kw = dict(mode=mode)
    if lerp:
        kw.update(g_lo=tables[0], g_w=tables[1])
    u, c, carry0 = sweep_inputs(n, S, R, gen, dev)
    got = k2.sweep(G_re, G_im, u, c, carry0, **kw)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = k2.plain_sweep(G_re, G_im, u, c, carry0, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = rel_err(got, ref)
    name = variant_name(mode, G_re.dtype == torch.bfloat16, shared, lerp, R)
    if not (rel <= K2_TOL and math.isfinite(rel)):
        fail(f"{name} n={n}: relative error {rel:.3e} > {K2_TOL}")
    rec = {"name": name, "n": n, "steps": S, "max_abs_err": err,
           "rel_err": rel, "tol": K2_TOL}
    if timed:
        width = R or 1
        panel_bytes = n * n * 2 * G_re.element_size()
        # every input read once, the output written once: u and out per
        # right-hand side, c, carry0; of G the panels this sweep uses (all
        # samples of a compressed stack, each ONCE)
        vec_bytes = ((2 * width + 1) * S + width) * n * 8
        panels = Mg if lerp else 1 if shared else S
        table_bytes = 12 * S if lerp else 0
        # the function of a lerp step is (w0 G[lo] + w1 G[lo+1]) @ V: the
        # two panels combined once (3 operations an entry of each plane)
        # and ONE product, whatever arithmetic the kernel chooses
        flops = (8 * width + (6 if lerp else 0)) * n * n * S
        rec["bound_ms"], rec["bound_by"] = bound(
            panels * panel_bytes + vec_bytes + table_bytes, flops)
        if lerp:
            # what the device memory would carry with no reuse of a panel
            # between steps: two panels a step
            rec["bound_no_reuse_ms"], _ = bound(
                2 * S * panel_bytes + vec_bytes + table_bytes, flops)
        rec["ms"] = time_ms(
            lambda: k2.sweep(G_re, G_im, u, c, carry0, **kw), 3)
        rec["plain_ms"] = plain_ms
        rec["library_ms"] = None
        rec["step_ms"] = rec["ms"] / S
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


# -- solves -------------------------------------------------------------------

def variant_key(mode, width, lerp):
    return f"{mode},R{width}{',lerp' if lerp else ''}"


def counted(fn):
    """Run fn() with every launch count set to zero just before and read
    just after; also the peak device memory of the run."""
    k1.reset_counts()
    k2.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    out = fn()
    torch.cuda.synchronize()
    # the wrapper counts sweeps by (mode, width, lerp); its totals by mode,
    # by width and with lerp tables are sums over that one count
    counts = {"stencil_matvec": k1.launches, "sweep": k2.launches, **{
                  f"sweep_{m}": c for m, c in k2.launches_by_mode.items()},
              "sweep_lerp": k2.launches_lerp,
              "sweep_by_width": {str(w): c for w, c
                                 in k2.launches_by_width.items()},
              "sweep_variants": {variant_key(*k): c for k, c
                                 in k2.launches_by_variant.items()}}
    return out, counts, torch.cuda.max_memory_allocated()


def counted_solve(cfg):
    return counted(lambda: ht.run_solver(
        cfg["n"], cfg["b"], cfg["wave_num"], cfg["const"],
        **{k: v for k, v in cfg.items()
           if k not in ("n", "b", "wave_num", "const")}))


def batched_launches(iteration_lists, lerp, restart=20):
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
            key = variant_key(mode, width, lerp)
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


def check_multisolve(name, cfg, recs, counts, peak, lerp, modes=None):
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
    want_k1, want_k2 = batched_launches([r["iterations"] for r in recs], lerp)
    if counts["stencil_matvec"] != want_k1:
        fail(f"{name}: {counts['stencil_matvec']} stencil launches, "
             f"{want_k1} implied by the iteration lists")
    if counts["sweep_variants"] != want_k2:
        fail(f"{name}: sweep launches {counts['sweep_variants']}, "
             f"{want_k2} implied by the iteration lists")
    if counts["sweep_lerp"] != (counts["sweep"] if lerp else 0):
        fail(f"{name}: {counts['sweep_lerp']} of {counts['sweep']} sweeps "
             "went through the lerp kernel")
    top = variant_key("bwd", cfg["n_sources"], lerp)
    if counts["sweep_variants"].get(top, 0) < 2:
        fail(f"{name}: the sweeps did not go through {top}")


def check_solve(name, cfg, rep, counts, peak, max_iters, exact_iters=None):
    restart = cfg.get("restart", 20)
    cycles = max(1, -(-rep.iterations // restart))
    # x0 = 0: one apply for M b, one apply and one product per inner
    # iteration, one of each for every cycle's recomputed residual; an apply
    # is one forward and one backward sweep
    want_k1 = rep.iterations + cycles
    want_apply = rep.iterations + cycles + 1
    say(name, iterations=rep.iterations, converged=rep.converged,
        true_residual=rep.true_residual, residual_norm=rep.residual_norm,
        init_time_s=rep.init_time, solve_time_s=rep.solve_time,
        peak_memory_bytes=peak, factor_stride=rep.config["factor_stride"],
        launches=counts, history=[float(h) for h in rep.history])
    if not rep.converged:
        fail(f"{name}: not converged")
    if exact_iters is not None and rep.iterations != exact_iters:
        fail(f"{name}: {rep.iterations} iterations, expected {exact_iters}")
    if rep.iterations > max_iters:
        fail(f"{name}: {rep.iterations} iterations > {max_iters}")
    if not rep.true_residual < 1e-3:
        fail(f"{name}: true residual {rep.true_residual:.3e} >= 1e-3")
    if not (np.isfinite(rep.u).all()
            and rep.u.shape == (cfg["n"], cfg["n"])):
        fail(f"{name}: solution not finite or of the wrong shape")
    if counts["stencil_matvec"] != want_k1:
        fail(f"{name}: {counts['stencil_matvec']} stencil launches, "
             f"{want_k1} implied by {rep.iterations} iterations")
    for mode in ("fwd", "bwd"):
        if counts[f"sweep_{mode}"] != want_apply:
            fail(f"{name}: {counts[f'sweep_{mode}']} {mode} sweeps, "
                 f"{want_apply} implied by {rep.iterations} iterations")
    if counts["sweep_bwd_sub"] != 0:
        fail(f"{name}: the corrected solve ran bwd_sub sweeps")


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
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
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
    keep(check_k2(*shared, "bwd", gen, timed=True, rows=Mg))
    for planes in (G32, G16):
        for mode in k2.MODES:
            keep(check_k2(*planes, mode, gen, timed=True, R=4,
                          library_step=(mode == "bwd")))
    keep(check_k2(*shared, "bwd", gen, timed=True, rows=Mg, R=4))
    for R in (2, 3):
        for mode in ("fwd", "bwd"):
            keep(check_k2(*G16, mode, gen, timed=True, R=R))
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
    del S32, S16
    torch.cuda.empty_cache()

    # every mode x type x kind of stack again at n = 33, for one, for an odd
    # number (3) and for more right-hand sides than one launch carries (5)
    G32s = random_g(33 - 6, 33, gen, dev)
    tables_s = lerp_tables(33 - 6, 4, dev)
    S32s = random_g(int(tables_s[0].max()) + 2, 33, gen, dev)
    for R in (None, 3, 5):
        for planes in (G32s, [g.to(torch.bfloat16) for g in G32s],
                       [g[:1].contiguous() for g in G32s]):
            for mode in k2.MODES:
                say("kernel", **check_k2(*planes, mode, gen, timed=False,
                                         rows=33 - 6, R=R))
        for planes in (S32s, [g.to(torch.bfloat16) for g in S32s]):
            for mode in k2.MODES:
                say("kernel", **check_k2(*planes, mode, gen, timed=False,
                                         R=R, tables=tables_s))

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

    if args.kernels_only:
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "kind": kind, "kernels_only": True,
                       "stencil_matvec": rec_k1, "sweep_variants": variants},
                      fh, indent=1)
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
    say("precision", iterations=rep.iterations, converged=rep.converged,
        true_residual=rep.true_residual, residual_norm=rep.residual_norm,
        init_time_s=rep.init_time, solve_time_s=rep.solve_time,
        peak_memory_bytes=peak, launches=counts,
        history=[float(h) for h in rep.history])
    if not rep.converged:
        fail("precision: not converged")
    if rep.iterations > MAX_ITERS_PRECISE:
        fail(f"precision: {rep.iterations} iterations > {MAX_ITERS_PRECISE}")
    if not rep.true_residual < 1e-5:
        fail(f"precision: true residual {rep.true_residual:.3e} >= 1e-5")
    if counts["sweep_variants"].get(variant_key("bwd", 1, False), 0) < \
            2 * rep.iterations or counts["sweep_lerp"]:
        fail(f"precision: sweep launches {counts['sweep_variants']}")
    paths["precision"] = counts
    record["precision"] = rep.metrics()

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
    launched = {(key, path): c for path, cs in paths.items()
                for key, c in cs["sweep_variants"].items()}
    for lerp in (False, True):
        for width in range(1, k2.MAX_WIDTH + 1):
            for mode in ("fwd", "bwd"):
                key = variant_key(mode, width, lerp)
                by_path = {p: c for (k, p), c in launched.items() if k == key}
                if not by_path:
                    continue
                R = None if width == 1 else width   # width 1: unbatched
                v = by_name[variant_name(mode, True, lerp=lerp, R=R)]
                table.append({
                    "name": v["name"], "route": "cuda",
                    "source": "helmholtz_tpu_torch/csrc/sweep.cu",
                    "replaces": "helmholtz_tpu/ops/pallas/sweep.py:"
                                + ("298" if lerp else "302"),
                    "launches": sum(by_path.values()),
                    "launches_by_path": by_path,
                    **{k: v[k] for k in keys},
                    "steps_per_launch": v["steps"], "step_ms": v["step_ms"],
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
                           "sweep_bwd[bf16]"])):
        for name in wanted:
            if names.get(name, {}).get("launches_by_path", {}) \
                    .get(path, 0) < 1:
                fail(f"{name} was not launched by the {path} path")

    seconds = time.perf_counter() - t_start
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"nvidia_smi": smi, "kind": kind, "seconds": seconds,
                   "stencil_matvec": rec_k1, "sweep_variants": variants,
                   "kernels": table, "launches": paths, **record}, fh,
                  indent=1)
    say("done", seconds=seconds)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
