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

then BiCGStab, the factor-free recompute preconditioner, checkpoints and
the roofline of the solver's parts:

  bicgstab      run_solver at the main configuration, method="bicgstab";
  bicgstab_multi  solve_multi_rhs(method="bicgstab") on the main path's
                operator and preconditioner, four seeded random sources,
                each against its own single solve;
  bicgstab9     run_solver at n = 511 on the 9-point scheme, BiCGStab;
  recompute     run_solver at the main configuration, precond="recompute"
                (stride 7: every apply re-factors 21 samples a chunk of
                128 sweep rows through the Gauss-Jordan kernel and sweeps
                each chunk through the sweep kernel's lerp mode), after one
                recompute apply held against the stored f32 apply and the
                apply's time split into re-factor, sweeps and H_F;
  recompute_multi  run_multisolve, four sources, precond="recompute";
  checkpoint    n = 255: build_preconditioner, save_preconditioner,
                load_preconditioner (the same apply to the bit), and
                resumable_gmres stopped after one checkpoint and resumed
                (the uninterrupted run to the bit);
  roofline_paths  bench.roofline measure_spmv / measure_setup /
                measure_sweep at n = 1023;
  profile_phases  an n = 255 run_solver inside utils.profiling.trace: the
                exported trace holds the assemble, factor and solve phases;

then the flagship scale, n = 2047 (b = 12, c1_f1, omega/2pi = 256, bf16 G,
stride 8; the JAX package's CAPACITY_COMPRESSED.jsonl, MULTISOLVE_n2047.jsonl
and NINEPOINT.jsonl records), the study and the command line:

  flagship      run_solver over compressed G (256 sample panels);
  flagship_dense  the same over the dense 34.12 GB stack (2035 panels,
                offsets past 2^31 elements a plane);
  flagship_multi  run_multisolve, omega/2pi = 256 and 255, four sources;
  flagship9     the 9-point scheme at b = 147, C = 60, four sources,
                through `cli.main(["multisolve", ...])` in this process;
  accuracy      bench.accuracy's refine study at n = 63, 127, 255 on both
                stencils (complex64, ir-df32);
  cli_main      `python -m helmholtz_tpu_torch solve --n 127 ...` in a
                subprocess (and the same arguments in this process, counted),
                and `plan --n 2047 --stencil 9pt`;

then the reference's other three problems (c1 / c2 media, f1 / f2
sources; the count limits from the complex128 oracle rows of
ORACLE_PROBLEMS.jsonl), a batch wider than one sweep launch, and n = 2047:

  problems      run_solver at the main configuration for c1_f2 (stride 7)
                and for c2_f1 and c2_f2, whose row-invariant media factor
                ONE subgrid and sweep its one shared panel (`dedup_hm`);
  cli_sweep     `sweep --problem c2_f2 --ns 127 255 511 1023` through
                `cli.main`: the reference's experiment harness;
  wide_batch    run_multisolve, eight sources of c1_f2 over compressed G:
                every sweep in launches of four, the eight members against
                the same sources solved as two batches of four;
  wide_dense    run_multisolve, sixteen sources of c1_f1 over the dense
                stack: every sweep ONE launch of the wide kernel;
  flagship_problems  run_solver at n = 2047 for c2_f1 (one shared 2047^2
                panel) and c1_f2 (compressed, stride 8);
  flagship_amortized  MULTISOLVE_AMORTIZED_n2047.jsonl's run: four
                frequencies, four sources, stride 16, an anchor every third;

then the distributed path (`helmholtz_tpu_torch.dist`): four ranks, one
process each, sharing the one card under gloo (NCCL refuses two ranks on
one GPU; the rows and sums they exchange are staged through host memory),
each phase beside the same call on one card in this process, every count
the single-card one +-1 and within its limit:

  dist_dryrun     `dist.dryrun` at n = 64 (its own checks of the batched
                  bf16, ir-df32 and 9-point legs against one card);
  dist_multisolve run_multisolve(mesh_devices=4) at n = 1024, omega/2pi =
                  128, four sources, bf16 G at the auto stride (dense);
  dist_amortized  three frequencies over compressed G at stride 7, the
                  middle one the omega-lerp of its anchors;
  dist_precision  one source at rtol 1e-6, precision="ir-df32", one
                  preconditioner refinement;
  dist9           the 9-point scheme at n = 1024 (b = 74, C = 60), three
                  frequencies over compressed G;
  dist_flagship   `multisolve --mesh 4 --n 2048 ...` through `cli.main`:
                  omega/2pi = 256, four sources, bf16 G compressed at
                  stride 8;

each rank's launches checked (K3 under its setup, two K2 launches for each
sweep chunk of its applies, on the 5-point scheme one K1 launch for each
band product), then each kernel held against its plain version at the
bands' shapes (`dist_band_k1`, the `band...` sweep variants);

  plan_check    the capacity planner's peak (bench.plan) beside the peak
                each full-width path allocated above what the script held
                before it, and each distributed path's highest rank peak
                beside `bench.plan.plan_distributed`'s;

Before the kernel phases it measures the card's peaks (`bench.roofline`:
read-only and streaming memory rates, float32 matrix-product rate) and
prints them on a line of their own; every kernel's bound is stated against
the card's published peaks, with the bound at the measured peaks beside
it.  The sweep kernel is also held against its plain version at n = 2047
(`k2_2047`: dense G and one shared panel with one stage of G in shared
memory, sample-compressed G with none), each variant's launch plan printed.  K4 is also timed for
its device work alone and its host cost, beside the library call's, and
two calls on the same inputs must give equal bits;
then every kernel instance its C entry point dispatches runs once, on a
small matrix with empty block rows and block rows cut between units
(pointers 16-byte aligned and not), against the plain version.  The
setup's batched inverse is timed by each route (the general and the
symmetric blocked Gauss-Jordan, pivoted LU) on the last layer's Schur blocks
at n = 1023 and 2047 (`blocked_inverse`), and the benchmark's two c1_f1
factors must send every Schur block to the symmetric route
(`factor_routes`); every path's counts carry `dense.inverses_by_route`.

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
import contextlib
import dataclasses
import functools
import io
import itertools
import json
import math
import os
import subprocess
import sys
import time

import numpy as np
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch import cli
from helmholtz_tpu_torch import driver as ht_driver
from helmholtz_tpu_torch.bench import plan as capacity
from helmholtz_tpu_torch.bench.accuracy import (convergence_orders,
                                                measure_error)
from helmholtz_tpu_torch.dist import launch
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops import dense
from helmholtz_tpu_torch.ops import spmv as plain_spmv
from helmholtz_tpu_torch.bench import roofline
from helmholtz_tpu_torch.ops.kernels import build
from helmholtz_tpu_torch.ops.kernels import bsr_spmm as k4
from helmholtz_tpu_torch.ops.kernels import gj_inverse as k3
from helmholtz_tpu_torch.ops.kernels import spmv_stencil as k1
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.ops.sparse_algebra import stencil_to_bsr
from helmholtz_tpu_torch.precond import recompute, sweeping, sweeping9
from helmholtz_tpu_torch.scripts import oracle_problems
from helmholtz_tpu_torch.solve.batched import solve_multi_rhs
from helmholtz_tpu_torch.solve.resumable import resumable_gmres
from helmholtz_tpu_torch.utils import checkpoint, profiling
from helmholtz_tpu_torch.bench.timing import (
    PUBLISHED_BYTES_PER_S, PUBLISHED_F32_FLOPS, device_ms)
from helmholtz_tpu_torch.scripts.common import (
    K4_INSTANCE_EMPTY, K4_INSTANCES, K4_RANDOM, bound_ms, bsr_as_csr,
    bsr_work, card, gj_matrices, host_ms, k4_instance, lerp_tables, randc,
    random_bsr, random_g, rel_err, schur_blocks, sweep_inputs, time_ms)

# The card's peaks as `main` measures them before the kernel phases
# (`bench.roofline`): the read-only memory rate in bytes/s and the float32
# matrix-product rate.  Every kernel's bound is taken at the card's
# published peaks (each kernel reads far more than it writes, and does
# float32 FMA outside the tensor cores); the bound at these beside it says
# how far the card's reachable rates are from them.
PEAKS = {}

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
# H_F's; 21: the samples of one recompute chunk at n = 1023; 146: the
# samples of the n = 1023 setup; 1000: a larger chunk) and
# panel widths 33 (odd), 64 (the blocked inverse's base case at every size
# used) and 128 (the kernel's largest)
K3_BATCHES = (1, 21, 146, 1000)
K3_WIDTHS = (33, 64, 128)
K3_MAIN = (146, 64)          # the shape timed for the kernel table

# BiCGStab on the main configuration and on the 9-point n = 511 one; the
# JAX package's own test pins at most 6 iterations with the sweep
BICG = dict(FULL, method="bicgstab")
BICG9 = dict(NINE_SMALL, method="bicgstab")
MAX_ITERS_BICG = 6
# the recompute preconditioner at the main configuration (auto stride 7; G
# is re-derived at the working precision, so no storage type), and batched
RECOMPUTE = dict({k: v for k, v in FULL.items() if k != "g_dtype"},
                 precond="recompute")
RECOMPUTE_MULTI = dict(wave_nums=[128.0], consts=[100.0], n_sources=4,
                       rtol=1e-3, precond="recompute")
RECOMPUTE_APPLY_TOL = 1e-4   # relative 2-norm, recompute against stored f32
# checkpoints and the profiled solve at n = 255
SMALL_255 = dict(n=255, b=12, wave_num=32.0, const=62.0)
# The flagship scale: n = 2047, the JAX package's headline records, every
# one with bf16 G at stride 8 (the auto stride there) over compressed G:
# CAPACITY_COMPRESSED.jsonl `compressed_stored_n2047` (7 iterations; the same
# over the dense stack here), MULTISOLVE_n2047.jsonl (omega/2pi = 256 and
# 255, four sources: [6, 7, 7, 6] both) and NINEPOINT.jsonl
# `ninepoint_flagship_2047_compressed` (b = 147, C = 60: [5, 4, 4, 5]).
FLAG = dict(n=2047, b=12, wave_num=256.0, const=100.0, problem="c1_f1",
            rtol=1e-3, restart=20, maxiter=60, g_dtype="bf16",
            g_compress=True)
FLAG_DENSE = dict(FLAG, g_compress=False)
FLAG_STRIDE = 8
FLAG_MULTI = dict(wave_nums=[256.0, 255.0], consts=[100.0], n_sources=4,
                  rtol=1e-3, g_dtype="bf16", factor_stride=FLAG_STRIDE,
                  g_compress=True)
FLAG9 = dict(n=2047, b=147, wave_nums=[256.0], consts=[60.0], n_sources=4)
FLAG9_ARGV = ["multisolve", "--stencil", "9pt", "--n", "2047", "--b", "147",
              "--freqs", "256", "--consts", "60", "--multi-rhs", "4",
              "--g-dtype", "bf16", "--factor-stride", "8", "--g-compress"]
MAX_ITERS_FLAG = 8            # the reference's 7 + 1
MAX_ITERS_FLAG9 = 6           # the reference's 5 + 1
# the accuracy study's refine sweep (the JAX package's ACCURACY.jsonl)
ACCURACY_NS = (63, 127, 255)
ACCURACY_WAVE_NUM = 8.0
# the command line at ORACLE.json's n = 127 configuration (oracle: 2)
CLI_SOLVE = ["solve", "--n", "127", "--wave-num", "16", "--const", "81"]
MAX_ITERS_CLI = 3
PLAN_RATIO = 1.05             # measured peak against the planner's, at most
# The reference's other three problems (c1 the Gaussian medium, c2 the
# medium that varies along the rows only; f1 the point source, f2 the
# directed beam) at the main configuration: c1_f2 at the auto stride 7, the
# row-invariant c2 media on their own path (`dedup_hm`: ONE factored
# subgrid, one shared panel in every sweep).  Limits: the complex128 scipy
# oracle's count for that problem and n (ORACLE_PROBLEMS.jsonl) + 1.
PROBLEMS = ("c1_f2", "c2_f1", "c2_f2")
ROW_INVARIANT = ("c2_f1", "c2_f2")
ORACLE_PROBLEMS = "ORACLE_PROBLEMS.jsonl"
# the reference's experiment harness on the card: the command line's sweep
# over n = 127 ... 1023 (omega/2pi = (n+1)/8, the reference's C for each n)
CLI_SWEEP_NS = (127, 255, 511, 1023)
CLI_SWEEP = ["sweep", "--problem", "c2_f2", "--ns",
             *map(str, CLI_SWEEP_NS)]
# more right-hand sides than one narrow sweep launch carries
# (k2.MAX_WIDTH = 4) over compressed G, which the wide kernel does not take:
# eight sources of c1_f2, each sweep in chunks of 4 + 4
WIDE = dict(wave_nums=[128.0], consts=[100.0], n_sources=8, rtol=1e-3,
            problem="c1_f2", g_dtype="bf16", factor_stride=LERP_STRIDE,
            g_compress=True)
WIDE_X_TOL = 1e-5             # the eight members against two batches of 4
# sixteen sources over the dense stack: every apply ONE launch of the wide
# sweep kernel a direction, at each width the batch passes through
WIDE_DENSE = dict(wave_nums=[128.0], consts=[100.0], n_sources=16,
                  rtol=1e-3, g_dtype="bf16")
# the wide kernel against its plain version at these widths (one slice,
# two, a padded third, four), timed at K2_WIDE_TIMED beside the same batch
# in launches of four; K2_WIDE_TABLE_R's row stands in the kernel table for
# every wide launch of a path.  float32 G at n = 2047 on a short dense
# stack: the whole one would take 68 GB.
K2_WIDE_RS = (5, 16, 29, 64)
K2_WIDE_TIMED = (16, 64)
K2_WIDE_TABLE_R = 64
K2_WIDE_F32_PANELS_2047 = 96
# n = 2047 for the other problems: c2_f1 over one shared 2047^2 panel, c1_f2
# over compressed G at stride 8.  The scipy oracle does not fit a host at
# n = 2047; c2_f1's limit is the port's own complex128 CPU count + 1
# (PORT_REFERENCE_n2047.jsonl, `scripts/oracle_problems.py --impl port`:
# one factored subgrid), c1_f2's, with no reference count, c1_f1's
PORT_REFERENCE = "PORT_REFERENCE_n2047.jsonl"
FLAG_PROBLEMS = {"flagship_c2_f1": dict(FLAG, problem="c2_f1"),
                 "flagship_c1_f2": dict(FLAG, problem="c1_f2")}
# MULTISOLVE_AMORTIZED_n2047.jsonl: four frequencies, an anchor every third
# (factor, omega_lerp, omega_lerp, factor), stride 16, four sources
FLAG_AMORTIZED = dict(wave_nums=[255.0, 256.0, 257.0, 258.0], consts=[100.0],
                      n_sources=4, rtol=1e-3, g_dtype="bf16",
                      factor_stride=16, g_compress=True, freq_anchor_every=3)
FLAG_AMORTIZED_ITERS = ([6, 7, 7, 6], [7, 7, 7, 7], [7, 7, 7, 6],
                        [7, 7, 7, 7])
# The distributed path: four ranks, one process each, sharing the one card
# under gloo (NCCL refuses two ranks on one GPU); n = 1024 and 2048, the
# multiples of 4 next to the single-card sizes, as the JAX package ran
# them.  Each phase also makes the same call on one card; every count must
# be the single-card one +-1 (reduction order and bf16 rounding) and within
# its limit.
DIST_RANKS = 4
DIST_LIMIT_S = 420            # a launch of the ranks fails past this
DIST_N, DIST_FLAG_N = 1024, 2048
DIST_DRYRUN_N = 64
DIST_MULTI = dict(MULTI, wave_nums=MULTI["wave_nums"][:1],
                  consts=MULTI["consts"][:1])
DIST_AMORTIZED = dict(AMORTIZED, wave_nums=AMORTIZED["wave_nums"][:3],
                      freq_anchor_every=2)
DIST_PRECISE = dict(wave_nums=[PRECISE["wave_num"]], consts=[PRECISE["const"]],
                    n_sources=1, **{k: PRECISE[k] for k in (
                        "rtol", "precision", "precond_refine", "g_dtype",
                        "maxiter")})
DIST9 = dict(NINE_MULTI)
DIST_FLAG = dict(wave_nums=[256.0], consts=[100.0], n_sources=4,
                 g_dtype="bf16", factor_stride=FLAG_STRIDE, g_compress=True)
DIST_FLAG_ARGV = ["multisolve", "--n", "2048", "--b", "12", "--freqs", "256",
                  "--consts", "100", "--multi-rhs", "4", "--g-dtype", "bf16",
                  "--factor-stride", "8", "--g-compress"]
#: name: (n, b, config, the most iterations a source, true residual below)
DIST_PHASES = {
    "dist_multisolve": (DIST_N, 12, DIST_MULTI, MAX_ITERS_BATCHED, 1e-3),
    "dist_amortized": (DIST_N, 12, DIST_AMORTIZED, MAX_ITERS_BATCHED, 1e-3),
    "dist_precision": (DIST_N, 12, DIST_PRECISE, MAX_ITERS_PRECISE, 1e-5),
    "dist9": (DIST_N, NINE["b"], DIST9, MAX_ITERS_BATCHED, 1e-3),
    "dist_flagship": (DIST_FLAG_N, 12, DIST_FLAG, MAX_ITERS_FLAG, 1e-3),
}
# the paths whose sweeps run float32 G (the rest run bf16), those that run
# the recompute preconditioner's chunk-sized sweeps, and those at n = 2047
F32_PATHS = ("recompute", "recompute_multi", "checkpoint", "accuracy",
             "cli_main", "cli_sweep")
CHUNK_PATHS = ("recompute", "recompute_multi")
BIG_PATHS = ("flagship", "flagship_dense", "flagship_multi", "flagship9",
             *FLAG_PROBLEMS, "flagship_amortized")
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
    """The least time of the work against the card's published peaks, and
    against the peaks measured in this run beside it."""
    ms, by = bound_ms(bytes_moved, flops, PUBLISHED_BYTES_PER_S,
                      PUBLISHED_F32_FLOPS)
    measured, _ = bound_ms(bytes_moved, flops, PEAKS["read_bytes_per_s"],
                           PEAKS["f32_flops"])
    return {"bound_ms": ms, "bound_by": by, "bound_measured_ms": measured}


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
        rec.update(bound(7 * 8 * points, 40 * points))
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


def variant_name(mode, bf16, shared=False, lerp=False, R=None, tri=False,
                 chunk=False, big=False, band=None):
    """`big`: a sweep at the flagship size n = 2047, whose launch plan
    differs from n = 1023's (16 rows a block; one stage of dense bf16 G,
    none of a sample pair).  `band`: a distributed band's sweep at grid
    size `band` (n / 4 rows a rank)."""
    return (f"sweep_{mode}[{'bf16' if bf16 else 'f32'}"
            f"{',shared' if shared else ''}{',lerp' if lerp else ''}"
            f"{',tri' if tri else ''}{',chunk' if chunk else ''}"
            f"{f',R{R}' if R else ''}{',n2047' if big else ''}"
            f"{f',band{band}' if band else ''}]")


def check_k2(G_re, G_im, mode, gen, timed, rows=None, library_step=False,
             R=None, tables=None, tri=False, chunk=False, band=False):
    """One sweep over `rows` grid rows (default: one per panel, or one per
    entry of the lerp tables) through the kernel and through the plain loop,
    for R right-hand sides (None: the unbatched call), with diagonal or
    (`tri`) tridiagonal coupling.  `chunk` names the recompute
    preconditioner's chunk-sized sweep, `band` a distributed band's."""
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
    wide = (R or 1) > k2.MAX_WIDTH and not (lerp or shared or tri)
    if wide and not torch.equal(got, k2.sweep(G_re, G_im, u, c, carry0,
                                              **kw)):
        fail(f"sweep_{mode} n={n} R={R}: two wide calls on the same inputs "
             "differ")
    t0 = time.perf_counter()
    ref = k2.plain_sweep(G_re, G_im, u, c, carry0, **kw)
    torch.cuda.synchronize()
    plain_ms = (time.perf_counter() - t0) * 1e3
    err, rel = rel_err(got, ref)
    name = variant_name(mode, G_re.dtype == torch.bfloat16, shared, lerp, R,
                        tri, chunk, big=n == FLAG["n"],
                        band=n if band else None)
    if not (rel <= K2_TOL and math.isfinite(rel)):
        fail(f"{name} n={n}: relative error {rel:.3e} > {K2_TOL}")
    rec = {"name": name, "n": n, "steps": S, "max_abs_err": err,
           "rel_err": rel, "tol": K2_TOL}
    if wide:
        rec["bits_equal"] = True
    if timed and wide:
        # the same batch in launches of four through the narrow kernel, as
        # it ran before the wide one
        parts = [(u[:, r0:r0 + k2.MAX_WIDTH].contiguous(),
                  carry0[r0:r0 + k2.MAX_WIDTH].contiguous())
                 for r0 in range(0, R, k2.MAX_WIDTH)]
        rec["chunked_launches"] = len(parts)
        rec["chunked_ms"] = time_ms(lambda: [
            k2.sweep(G_re, G_im, uc, c, cc, **kw) for uc, cc in parts], 3)
        del parts
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
        rec.update(bound(panels * panel_bytes + vec_bytes + table_bytes,
                         flops))
        if lerp:
            # what the device memory would carry with no reuse of a panel
            # between steps: two panels a step
            rec["bound_no_reuse_ms"] = bound(
                2 * S * panel_bytes + vec_bytes + table_bytes,
                flops)["bound_ms"]
        k2.reset_counts()
        rec["ms"] = time_ms(
            lambda: k2.sweep(G_re, G_im, u, c, carry0, **kw), 3)
        rec["plain_ms"] = plain_ms
        rec["library_ms"] = None
        rec["step_ms"] = rec["ms"] / S
    # the plan of each launch that the wrapper made in the (timed) call,
    # one a launch width (`k2.launch_widths`), as it recorded it
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


def check_k2_wide(planes, gen, keep, timed=K2_WIDE_TIMED):
    """The wide kernel on one dense stack: every mode at each width of
    K2_WIDE_RS against the plain version, two calls for equal bits (in
    `check_k2`), timed at `timed`; then every fourth source of a batch of
    64 alone as a batch of 16, which must give the same bits in every mode
    (a source's sums do not depend on the batch it rides in)."""
    for R in K2_WIDE_RS:
        for mode in k2.MODES:
            keep(check_k2(*planes, mode, gen, timed=R in timed, R=R,
                          library_step=(mode == "bwd" and R in timed)))
    G_re, G_im = planes
    Mg, n, _ = G_re.shape
    dev = G_re.device
    pick = torch.arange(0, 64, 4, device=dev)
    for mode in k2.MODES:
        S = Mg - 1 if mode == "fwd" else Mg
        u, c, carry0 = sweep_inputs(n, S, 64, gen, dev)
        whole = k2.sweep(G_re, G_im, u, c, carry0, mode=mode)
        alone = k2.sweep(G_re, G_im, u[:, pick].contiguous(), c,
                         carry0[pick].contiguous(), mode=mode)
        if not torch.equal(whole[:, pick], alone):
            fail(f"sweep_{mode} n={n}: sixteen sources alone differ from "
                 "the same sixteen in a batch of 64")
        del u, c, carry0, whole, alone
    say("k2_wide_batches", n=n, g_dtype=str(G_re.dtype),
        sources=pick.tolist(), bits_equal=True)


def random_g_bf16(Mg, n, gen, dev, chunk=64):
    """`random_g`'s planes stored as bfloat16, drawn chunk by chunk: the
    float32 planes of the n = 2047 dense stack would take 68 GB."""
    ld = k2.g_ld(n)
    sigma = 0.25 / math.sqrt(n) / math.sqrt(2.0)
    planes = []
    for _ in range(2):
        g = torch.zeros((Mg, n, ld), dtype=torch.bfloat16, device=dev)
        for s in range(0, Mg, chunk):
            e = min(s + chunk, Mg)
            g[s:e, :, :n] = torch.randn((e - s, n, n), generator=gen,
                                        device=dev) * sigma
        planes.append(g)
    return planes


def check_k2_2047(gen, dev, keep):
    """K2 at the flagship size against its plain version: dense bf16 G over
    all 2035 sweep rows (34.12 GB: a plane passes 2^31 elements), R = 1,
    and the wide kernel at R = 5 to 64 (`check_k2_wide`; float32 G over
    K2_WIDE_F32_PANELS_2047 panels);
    one shared bf16 panel over 2035 rows, R = 1; stride-8 bf16 samples with
    the compressed setup's tables, diagonal coupling over 2035 rows and
    tridiagonal over the 9-point path's 1900, R = 1 to 4, and stride-16
    samples (untimed), R = 1 to 4.  Returns the timed variants' names and
    launch plans."""
    n = FLAG["n"]
    M, M9 = n - FLAG["b"], n - FLAG9["b"]
    recs = []
    G = random_g_bf16(M, n, gen, dev)
    for mode in ("fwd", "bwd"):
        recs.append(check_k2(*G, mode, gen, timed=True,
                             library_step=(mode == "bwd")))
    # the wide kernel over the whole dense bf16 stack, and over a short
    # float32 one
    check_k2_wide(G, gen, recs.append)
    G32 = random_g(K2_WIDE_F32_PANELS_2047, n, gen, dev)
    check_k2_wide(G32, gen, recs.append)
    del G32
    # one shared panel (c2_f1 at n = 2047): sixteen bf16 rows a block held
    # in one stage of shared memory for the whole sweep
    for mode in ("fwd", "bwd"):
        recs.append(check_k2(*(g[:1].contiguous() for g in G), mode, gen,
                             timed=True, rows=M,
                             library_step=(mode == "bwd")))
    del G
    torch.cuda.empty_cache()
    tables = lerp_tables(M, FLAG_STRIDE, dev)
    tables9 = lerp_tables(M9, FLAG_STRIDE, dev)
    S = random_g_bf16(int(tables[0].max()) + 2, n, gen, dev)
    S9 = [g[:int(tables9[0].max()) + 2] for g in S]
    for R in (None, 2, 3, 4):
        for mode in ("fwd", "bwd"):
            recs.append(check_k2(*S, mode, gen, timed=True, R=R,
                                 tables=tables))
            recs.append(check_k2(*S9, mode, gen, timed=True, R=R,
                                 tables=tables9, tri=True))
    # the amortized n = 2047 sweep's stride 16 (129 samples), untimed: the
    # table keeps the stride-8 times of these variants
    tables16 = lerp_tables(M, FLAG_AMORTIZED["factor_stride"], dev)
    S16 = [g[:int(tables16[0].max()) + 2] for g in S]
    for R in (None, 2, 3, 4):
        for mode in ("fwd", "bwd"):
            rec = check_k2(*S16, mode, gen, timed=False, R=R,
                           tables=tables16)
            say("kernel", stride=FLAG_AMORTIZED["factor_stride"], **rec)
    del S, S9, S16
    torch.cuda.empty_cache()
    for rec in recs:
        keep(rec)
    return [{"name": r["name"], "steps": r["steps"], "rel_err": r["rel_err"],
             "ms": r.get("ms"), "plans": r["plans"],
             **{k: r[k] for k in ("step_ms", "step_library_ms") if k in r}}
            for r in recs]


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
        rec.update(bound(16 * k * k * B, 8 * k ** 3 * B))
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


#: the routes of the setup's batched inverse: name -> the call
INVERSE_ROUTES = {
    "gauss_jordan": dense.batched_inverse,
    "gauss_jordan_sym": dense.batched_inverse_sym,
    "linalg_inv": functools.partial(dense.batched_inverse, pivoted=True),
}


def check_blocked_inverse(flush):
    """The setup's batched inverse at its main shapes, every route on the
    same last-layer Schur blocks, and at a batch of one (one Schur block:
    what H_F's stack and the one-subgrid setups pay): n = 1023, the 146
    stride-7 samples in one batch; n = 2047, one setup chunk of the
    stride-8 samples (50).  Each route's residual, ms, workspace, K3
    launches and rate at 8 n^3 and at its own operation count
    (`dense.blocked_gj_flops`).  The symmetric route must need no more
    workspace than the general one and launch K3 as often."""
    recs = []
    for cfg, stride in ((FULL, LERP_STRIDE), (FLAG, FLAG_STRIDE)):
        n = cfg["n"]
        B = min(len(sweeping.sample_positions(n - cfg["b"], stride)),
                sweeping._clamped_chunk(sweeping.DEFAULT_SETUP_CHUNK, n))
        S = schur_blocks(cfg, stride, B)
        one = S[:1].contiguous()
        rec = {"batch": B, "n": n, "tol": INV_TOL}
        for route, inverse in INVERSE_ROUTES.items():
            k3.reset_counts()
            X = inverse(S)
            torch.cuda.synchronize()
            rec[f"{route}_k3_launches"] = k3.launches
            rec[f"{route}_residual"] = inverse_residual(X, S)
            del X
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            ms = time_ms(lambda: inverse(S), 3, flush) / B
            rec[f"{route}_ms_per_inverse"] = ms
            rec[f"{route}_workspace_bytes"] = (
                torch.cuda.max_memory_allocated() - base)
            # the operations of one inverse, 8 n^3, at the achieved rate
            rec[f"{route}_tflops"] = 8 * n ** 3 / (ms * 1e-3) / 1e12
            if route != "linalg_inv":
                rec[f"{route}_flops_own"] = dense.blocked_gj_flops(
                    n, symmetric=route == "gauss_jordan_sym")
                rec[f"{route}_tflops_own"] = (
                    rec[f"{route}_flops_own"] / (ms * 1e-3) / 1e12)
            rec[f"{route}_batch1_residual"] = inverse_residual(
                inverse(one), one)
            rec[f"{route}_batch1_ms"] = time_ms(lambda: inverse(one), 5,
                                                flush)
        for route, key in itertools.product(INVERSE_ROUTES,
                                            ("residual", "batch1_residual")):
            if not rec[f"{route}_{key}"] < INV_TOL:
                fail(f"blocked_inverse n={n}: {route} {key} "
                     f"{rec[f'{route}_{key}']:.3e} >= {INV_TOL}")
        if (rec["gauss_jordan_sym_workspace_bytes"]
                > rec["gauss_jordan_workspace_bytes"]):
            fail(f"blocked_inverse n={n}: the symmetric route's workspace "
                 f"{rec['gauss_jordan_sym_workspace_bytes']} exceeds the "
                 f"general route's {rec['gauss_jordan_workspace_bytes']}")
        if (rec["gauss_jordan_sym_k3_launches"]
                != rec["gauss_jordan_k3_launches"]):
            fail(f"blocked_inverse n={n}: K3 launches "
                 f"{rec['gauss_jordan_sym_k3_launches']} (symmetric) "
                 f"against {rec['gauss_jordan_k3_launches']}")
        recs.append(rec)
        del S, one
        torch.cuda.empty_cache()
    return recs


#: the benchmark's c1_f1 factors (portbench/configs/c1_f1-n1023.json and
#: c1_f1-n2047.json): (configuration, stride, compressed)
FACTOR_ROUTE_CASES = ((FULL, LERP_STRIDE, False), (FLAG, FLAG_STRIDE, True))


def check_factor_routes():
    """The c1_f1 setups as the benchmark's cells run them (complex64, bf16
    G; n = 1023 stride 7 expanded, n = 2047 stride 8 compressed): every
    Schur block, the subgrid samples' and H_F's, must take the symmetric
    route, none the general one."""
    recs = []
    for cfg, stride, compress in FACTOR_ROUTE_CASES:
        n, b = cfg["n"], cfg["b"]
        hc = ht.HelmholtzConfig(n=n, b=b, wave_num=cfg["wave_num"],
                                const=cfg["const"])
        prob = ht.assemble_problem(hc, cfg["problem"],
                                   complex_dtype=torch.complex64)
        hm = fd_stencil.build_hm_stencils(n, b, hc.const, hc.eta, hc.omega,
                                          hc.h, prob.c_full,
                                          fidelity="corrected",
                                          complex_dtype=torch.complex64)
        dense.reset_counts()
        k3.reset_counts()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        P = sweeping.setup_preconditioner(prob.A, hm, b,
                                          g_dtype=torch.bfloat16,
                                          factor_stride=stride,
                                          g_compress=compress)
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
        samples = len(sweeping.sample_positions(n - b, stride))
        rec = {"n": n, "stride": stride, "compressed": compress,
               "samples": samples, "setup_s": seconds,
               "k3_launches": k3.launches,
               "inverses_by_route": dict(dense.inverses_by_route),
               "expected_sym": samples * b + b}
        if rec["inverses_by_route"] != {"sym": samples * b + b,
                                        "general": 0}:
            fail(f"factor_routes n={n}: {rec['inverses_by_route']}, "
                 f"expected {samples * b + b} symmetric and none general")
        recs.append(rec)
        del prob, hm, P
        torch.cuda.empty_cache()
    return recs


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

def check_k4(A, K, gen, flush, timed, library=None, X=None):
    """K4 against its plain version on one input (X, random where not
    given), and two calls on it for equal bits.  Timed: the call (CUDA
    events around the Python call, after an L2 flush), the device's work of
    the call alone (`device_ms`) and the call's host time, and the same
    three for the library call."""
    if X is None:
        X = randc((A.shape[1], K), gen, A.device)
    got = k4.bsr_matmat(A, X)
    again = k4.bsr_matmat(A, X)
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
    if not torch.equal(got, again):
        fail(f"{what}: two calls on the same inputs differ")
    plan = k4.launch_plan(A.shape[0] // bm, bm, bn, K, A.data.shape[0],
                          k4._sm_count(A.device), A.data.data_ptr() % 16 == 0,
                          X.data_ptr() % 16 == 0)
    rec = {"nblocks": A.data.shape[0], "blocksize": [bm, bn], "K": K,
           "max_abs_err": err, "rel_err": rel, "tol": K4_TOL,
           "bits_equal": True, "plan": dataclasses.asdict(plan),
           "instance": list(k4_instance(plan))}
    if timed:
        rec.update(bound(*bsr_work(A, K)))
        call = lambda: k4.bsr_matmat(A, X)      # noqa: E731
        rec["ms"] = time_ms(call, 5, flush)
        rec["device_ms"] = device_ms(call, 5, flush)
        rec["host_ms"] = host_ms(call, 10)
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
            lib_call = lambda: library @ X      # noqa: E731
            rec["library_ms"] = time_ms(lib_call, 5, flush)
            rec["library_device_ms"] = device_ms(lib_call, 5, flush)
            rec["library_host_ms"] = host_ms(lib_call, 10)
    return rec


def misaligned(t):
    """t's values in a contiguous tensor whose pointer lies 8 bytes past a
    16-byte boundary (complex64: one element into its buffer)."""
    buf = torch.empty(t.numel() + 1, dtype=t.dtype, device=t.device)
    out = buf[1:].view(t.shape)
    out.copy_(t)
    assert out.data_ptr() % 16 == 8
    return out


def check_k4_instances(gen, dev):
    """Every kernel instance that K4's C entry point dispatches, once, at a
    shape whose plan selects it (`K4_INSTANCES`: 16 x 12 blocks, block rows
    0, 3 and 15 empty; on this card's SM count every chunk holds one stored
    block, so every block row of two or more is cut between units and
    summed by the fix-up kernel), then a streaming and a tiled case with
    the data or X 8 bytes off a 16-byte boundary: each against the plain
    version within K4_TOL, two calls with equal bits, and the plan's
    instance the one wanted."""
    cases = [(inst, shape, None) for inst, shape in K4_INSTANCES] + [
        (("stream", 1, 1, 32), (24, 64, 1), "data"),
        (("tiled", 2, True, False), (64, 40, 16), "X")]
    recs = []
    for inst, (bm, bn, K), shifted in cases:
        A = random_bsr(16, 12, bm, bn, gen, dev, empty=K4_INSTANCE_EMPTY)
        X = randc((A.shape[1], K), gen, dev)
        if shifted == "data":
            A = dataclasses.replace(A, data=misaligned(A.data))
        elif shifted == "X":
            X = misaligned(X)
        rec = check_k4(A, K, gen, None, timed=False, X=X)
        rec["misaligned"] = shifted
        if tuple(rec["instance"]) != inst:
            fail(f"bsr_matmat ({bm}, {bn}), K={K}: the plan selects "
                 f"{rec['instance']}, want {list(inst)}")
        recs.append(rec)
    return recs


# -- solves -------------------------------------------------------------------

def variant_key(mode, width, lerp, tri=False, shared=False):
    return (f"{mode},R{width}{',lerp' if lerp else ''}"
            f"{',tri' if tri else ''}{',shared' if shared else ''}")


#: the device memory of each named counted run: its peak and what was
#: allocated when it started (the script's own buffers), by path
PATH_MEMORY = {}


def counted(fn, name=None):
    """Run fn() with every launch count set to zero just before and read
    just after; also the peak device memory of the run (kept under `name`
    in PATH_MEMORY with what was allocated before it, where given)."""
    for k in (k1, k2, k3, k4, dense):
        k.reset_counts()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    out = fn()
    torch.cuda.synchronize()
    # the sweep wrapper counts by (mode, width, lerp, tri, shared); its
    # totals by mode, by width, with lerp tables and over one shared panel
    # are sums over that one count
    counts = {"stencil_matvec": k1.launches, "sweep": k2.launches,
              "gj_inverse": k3.launches, "bsr_matmat": k4.launches,
              "inverses_by_route": dict(dense.inverses_by_route), **{
                  f"sweep_{m}": c for m, c in k2.launches_by_mode.items()},
              "sweep_lerp": k2.launches_lerp,
              "sweep_shared": k2.launches_shared,
              "sweep_by_width": {str(w): c for w, c
                                 in k2.launches_by_width.items()},
              "sweep_variants": {variant_key(*k): c for k, c
                                 in k2.launches_by_variant.items()}}
    peak = torch.cuda.max_memory_allocated()
    if name:
        PATH_MEMORY[name] = {"peak_bytes": peak, "base_bytes": base}
    return out, counts, peak


def k3_in_solve_phases(fn):
    """(fn(), the K3 launches made inside the driver's "solve" phases): the
    driver's `phase` is wrapped for the call, so the setup's and the
    solve's shares of one run's count are read in that same run."""
    inner = ht_driver.phase
    window = [0]

    @contextlib.contextmanager
    def marked(name):
        start = k3.launches
        with inner(name):
            yield
        if name == "solve":
            window[0] += k3.launches - start

    ht_driver.phase = marked
    try:
        return fn(), window[0]
    finally:
        ht_driver.phase = inner


def solve_with(cfg):
    return ht.run_solver(cfg["n"], cfg["b"], cfg["wave_num"], cfg["const"],
                         **{k: v for k, v in cfg.items()
                            if k not in ("n", "b", "wave_num", "const")})


def counted_solve(cfg, name=None):
    return counted(lambda: solve_with(cfg), name)


def sweep_widths(width, lerp, tri=False, n=FULL["n"], g_bytes=2):
    """The launch widths of one sweep of `width` right-hand sides on this
    card (`k2.launch_widths`): one wide launch over a dense stack with
    diagonal coupling, else chunks of at most four."""
    return k2.launch_widths(width, n, g_bytes, lerp, False, tri,
                            k2._sm_count(torch.device("cuda")))


def batched_launches(iteration_lists, lerp, restart=20, tri=False,
                     n=FULL["n"], g_bytes=2):
    """Launches that the lockstep batched GMRES makes for these per-source
    iteration counts, one list per frequency, when every source converges
    inside its first restart cycle: an apply of the whole batch for M b; at
    inner step j one product per source still iterating and one apply of
    that width; then one product per source and one apply of the whole
    batch for the recomputed residuals.  An apply is one forward and one
    backward sweep in each launch width of `sweep_widths` (grid n, G of
    `g_bytes` bytes an element)."""
    products, variants = 0, {}

    def apply(width):
        for w in sweep_widths(width, lerp, tri, n, g_bytes):
            for mode in ("fwd", "bwd"):
                key = variant_key(mode, w, lerp, tri)
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
                     tri=False, max_iters=MAX_ITERS_BATCHED, n=FULL["n"]):
    """`tri`: a 9-point sweep, whose operator products launch no kernel and
    whose sweeps take the tridiagonal-coupling variants.  `n`: the grid."""
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
        if max(r["iterations"]) > max_iters:
            fail(f"{what}: iterations {r['iterations']} > {max_iters}")
        if bool(r["g_compress"]) != lerp:
            fail(f"{what}: g_compress is {r['g_compress']}")
    g_bytes = 2 if cfg.get("g_dtype", "bf16") == "bf16" else 4
    want_k1, want_k2 = batched_launches([r["iterations"] for r in recs], lerp,
                                        tri=tri, n=n, g_bytes=g_bytes)
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
    top = variant_key("bwd", sweep_widths(cfg["n_sources"], lerp, tri, n,
                                          g_bytes)[0], lerp, tri)
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
                residual_below=1e-3, applies_per_call=1, lerp=False,
                shared=False):
    """`applies_per_call`: 2 when the preconditioner is refined once;
    `lerp`: the sweeps run over sample-compressed G; `shared`: over one
    shared panel (a row-invariant medium's one factored subgrid)."""
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
            key = variant_key(mode, 1, lerp, tri, shared)
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
             if ("tri" in k.split(",")) != tri
             or ("shared" in k.split(",")) != shared]
    if (wrong or counts["sweep_lerp"] != (counts["sweep"] if lerp else 0)
            or counts["sweep_shared"] != (counts["sweep"] if shared else 0)):
        fail(f"{name}: sweeps through {counts['sweep_variants']}")
    check_setup_launches(name, counts)

# -- BiCGStab, recompute, checkpoints, roofline, phases -----------------------

def check_bicgstab(name, cfg, rep, counts, peak, max_iters):
    """BiCGStab from x0 = 0: one operator product for r0 = b - A x0 (kept
    for the zero x0, as in the JAX package), two products and two applies
    an iteration, one product for the final true residual; an apply is one
    forward and one backward sweep.  So K1 = 2 it + 2 (none on the 9-point
    path, whose product is plain tensor code) and K2 = 4 it."""
    tri = cfg.get("stencil") == "9pt"
    say(name, iterations=rep.iterations, converged=rep.converged,
        true_residual=rep.true_residual, residual_norm=rep.residual_norm,
        init_time_s=rep.init_time, solve_time_s=rep.solve_time,
        peak_memory_bytes=peak, factor_stride=rep.config["factor_stride"],
        launches=counts, history=[float(h) for h in rep.history])
    it = rep.iterations
    if not rep.converged:
        fail(f"{name}: not converged")
    if it > max_iters:
        fail(f"{name}: {it} iterations > {max_iters}")
    if not rep.true_residual < 1e-3:
        fail(f"{name}: true residual {rep.true_residual:.3e}")
    if not (np.isfinite(rep.u).all()
            and rep.u.shape == (cfg["n"], cfg["n"])):
        fail(f"{name}: solution not finite or of the wrong shape")
    k1_count = counts["stencil_matvec"]
    sweeps = {m: counts[f"sweep_{m}"] for m in ("fwd", "bwd", "bwd_sub")}
    if k1_count != (0 if tri else 2 * it + 2):
        fail(f"{name}: {k1_count} stencil launches, want 2 * {it} + 2")
    if sweeps != {"fwd": 2 * it, "bwd": 2 * it, "bwd_sub": 0}:
        fail(f"{name}: sweeps {sweeps}, want 2 * {it} forward and backward")
    wrong = [k for k in counts["sweep_variants"]
             if k != variant_key(k.split(",")[0], 1, False, tri)]
    if wrong:
        fail(f"{name}: sweeps through {counts['sweep_variants']}")
    check_setup_launches(name, counts)


def bicgstab_multi(gen, dev):
    """The lockstep batched BiCGStab on the main path's operator and
    preconditioner (its setup inside the counted window), four seeded
    random sources; then each source's own single solve, outside it."""
    n, b = FULL["n"], FULL["b"]
    kw = dict(rtol=FULL["rtol"], maxiter=FULL["maxiter"])
    state = {}

    def run():
        A, hm, _ = ht_driver._assemble_stage(
            FULL["wave_num"], FULL["const"], 2.0, n=n, b=b,
            problem=FULL["problem"], fidelity="corrected",
            cdtype=torch.complex64, device=dev)
        P = ht_driver._factor_stage(
            A, hm, b=b, hf_full_coupling=True, d2_replace=True,
            setup_chunk=sweeping.DEFAULT_SETUP_CHUNK, g_dtype="bf16",
            factor_stride=LERP_STRIDE, device=dev)
        del hm
        X = randc((4, n * n), gen, dev)
        mv = lambda V: torch.stack(                       # noqa: E731
            [k1.stencil_matvec_flat(A, v) for v in V])
        state.update(A=A, P=P, X=X)
        t0 = time.perf_counter()
        res = solve_multi_rhs(mv, X, M=P, method="bicgstab", **kw)
        torch.cuda.synchronize()
        state["solve_s"] = time.perf_counter() - t0
        return res

    res, counts, peak = counted(run)
    A, P, X = state["A"], state["P"], state["X"]
    singles = [ht.bicgstab(lambda v: k1.stencil_matvec_flat(A, v), x, M=P,
                           **kw) for x in X]
    its = res.iterations.tolist()
    one = [s.iterations for s in singles]
    true_res = [((k1.stencil_matvec_flat(A, res.x[i]) - X[i]).norm()
                 / X[i].norm()).item() for i in range(4)]
    say("bicgstab_multi", iterations=its, single_iterations=one,
        converged=res.converged.tolist(), true_residuals=true_res,
        solve_time_s=state["solve_s"], peak_memory_bytes=peak,
        launches=counts)
    if not res.converged.all():
        fail(f"bicgstab_multi: not converged: {res.converged.tolist()}")
    if any(abs(a - c) > 1 for a, c in zip(its, one)):
        fail(f"bicgstab_multi: iterations {its} against single solves {one}")
    # products: r0 and the final residual per source, two per source and
    # step; sweeps: two applies a step of the width still iterating
    want = {}
    for j in range(max(its)):
        width = sum(1 for it in its if it > j)
        for mode in ("fwd", "bwd"):
            key = variant_key(mode, width, False)
            want[key] = want.get(key, 0) + 2
    if counts["stencil_matvec"] != 2 * sum(its) + 8:
        fail(f"bicgstab_multi: {counts['stencil_matvec']} stencil launches,"
             f" want 2 * {sum(its)} + 8")
    if counts["sweep_variants"] != want:
        fail(f"bicgstab_multi: sweeps {counts['sweep_variants']}, want "
             f"{want}")
    if not counts["sweep_variants"].get(variant_key("bwd", 4, False)):
        fail("bicgstab_multi: K2 did not run its R = 4 mode")
    check_setup_launches("bicgstab_multi", counts)
    del A, P, X
    torch.cuda.empty_cache()
    return counts


def range_device_ms(prof, names):
    """Device time in ms of the kernels launched inside each named range of
    a profile, summed over the range's occurrences."""
    out = {}
    for e in prof.key_averages():
        if e.key in names:
            us = getattr(e, "device_time_total", None)
            if us is None:
                us = e.cuda_time_total
            out[e.key] = us / 1e3
    return out


def recompute_apply_check(dev):
    """One recompute apply at the main configuration (stride 7) against the
    stored apply over float32 planes at the same stride, for the same f;
    the K3 launches of the recompute setup alone (H_F's stack, fixed by the
    shapes; printed beside the setup's share in the solves' own runs); and
    one apply under torch.profiler, split into re-factor, sweeps and
    H_F."""
    n, b = FULL["n"], FULL["b"]
    A, c_full, f = ht_driver._assemble_a_stage(
        FULL["wave_num"], FULL["const"], 2.0, n=n, b=b,
        problem=FULL["problem"], fidelity="corrected",
        cdtype=torch.complex64, device=dev)
    f = f.to(torch.complex64)
    cfg = ht.HelmholtzConfig(n=n, b=b, wave_num=FULL["wave_num"],
                             const=FULL["const"])
    hm = fd_stencil.build_hm_stencils(n, b, cfg.const, cfg.eta, cfg.omega,
                                      cfg.h, c_full, fidelity="corrected",
                                      complex_dtype=torch.complex64)
    P = sweeping.setup_preconditioner(A, hm, b, g_dtype=torch.float32,
                                      factor_stride=LERP_STRIDE)
    del hm
    stored = sweeping.apply_preconditioner(P, f)
    del P
    torch.cuda.empty_cache()

    def setup():
        return ht_driver._factor_recompute_stage(
            A, c_full, FULL["wave_num"], FULL["const"], 2.0, n=n, b=b,
            fidelity="corrected", hf_full_coupling=True, d2_replace=True,
            factor_stride=LERP_STRIDE)

    R, setup_counts, _ = counted(setup)
    got = recompute.apply_recompute(R, f)
    torch.cuda.synchronize()
    rel = ((got - stored).norm() / stored.norm()).item()
    fwd, bwd = recompute.chunk_plan(R)
    # one more apply, timed whole, then one under the profiler
    t0 = time.perf_counter()
    _, apply_counts, apply_peak = counted(
        lambda: recompute.apply_recompute(R, f))
    apply_s = time.perf_counter() - t0
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with profiling.annotate("recompute.apply"):
            recompute.apply_recompute(R, f)
        torch.cuda.synchronize()
    by_kernel = {}
    for e in prof.events():
        # the named ranges appear on the device's timeline too; they are
        # read by range_device_ms, and kept out of the kernels' sum
        if e.device_type == torch.autograd.DeviceType.CUDA \
                and not e.name.startswith("recompute."):
            by_kernel[e.name] = (by_kernel.get(e.name, 0.0)
                                 + e.time_range.elapsed_us() / 1e3)
    busy = sum(by_kernel.values())
    ranges = range_device_ms(
        prof, ("recompute.apply", "recompute.refactor", "recompute.sweep"))
    # the H_F solves carry no range of their own: their share is what the
    # apply's range holds beyond the re-factors and the sweeps
    ranges["recompute.hf"] = (ranges.pop("recompute.apply", 0.0)
                              - ranges.get("recompute.refactor", 0.0)
                              - ranges.get("recompute.sweep", 0.0))
    split = {
        "apply_s": apply_s, "apply_peak_bytes": apply_peak,
        "chunks_fwd": len(fwd), "chunks_bwd": len(bwd),
        "chunk_rows": recompute.chunk_rows(R),
        "samples_per_chunk": recompute.sample_window(
            recompute.chunk_rows(R), LERP_STRIDE),
        "launches_per_apply": apply_counts,
        "device_busy_ms": busy,
        "k3_kernel_ms": sum(t for k, t in by_kernel.items()
                            if "gj_inverse_kernel" in k),
        "k2_kernel_ms": sum(t for k, t in by_kernel.items()
                            if "sweep_kernel" in k),
        "range_device_ms": ranges,
        "top_kernels_ms": [[k[:100], t] for k, t in sorted(
            by_kernel.items(), key=lambda kv: -kv[1])[:8]],
    }
    say("recompute_apply", n=n, factor_stride=LERP_STRIDE,
        rel_2norm_vs_stored_f32=rel, tol=RECOMPUTE_APPLY_TOL,
        setup_launches=setup_counts, **split)
    if not rel <= RECOMPUTE_APPLY_TOL:
        fail(f"recompute_apply: {rel:.3e} from the stored f32 apply > "
             f"{RECOMPUTE_APPLY_TOL}")
    k3_apply = apply_counts["gj_inverse"]
    if k3_apply < 1 or apply_counts["sweep"] != len(fwd) + len(bwd) \
            or apply_counts["sweep_lerp"] != apply_counts["sweep"]:
        fail(f"recompute_apply: launches {apply_counts}")
    return setup_counts["gj_inverse"], k3_apply, len(fwd) + len(bwd), split


def check_recompute(rep, counts, peak, stored_peak, k3_setup, k3_solve,
                    k3_apply, chunks):
    """GMRES from x0 = 0 makes it + cycles + 1 applies; each apply walks
    `chunks` chunk sweeps (K2) and re-factors every chunk (K3, k3_apply
    launches an apply).  k3_solve: the K3 launches inside the run's solve
    phase, read in the run (`k3_in_solve_phases`)."""
    it = rep.iterations
    cycles = max(1, -(-it // RECOMPUTE.get("restart", 20)))
    applies = it + cycles + 1
    say("recompute", iterations=it, converged=rep.converged,
        true_residual=rep.true_residual, residual_norm=rep.residual_norm,
        init_time_s=rep.init_time, solve_time_s=rep.solve_time,
        peak_memory_bytes=peak, stored_solve_peak_bytes=stored_peak,
        factor_stride=rep.config["factor_stride"], applies=applies,
        k3_launches_solve_window=k3_solve,
        k3_launches_setup=counts["gj_inverse"] - k3_solve,
        k3_launches_setup_alone=k3_setup, launches=counts,
        history=[float(h) for h in rep.history])
    if not rep.converged or it > ORACLE_ITERS_FULL + 1:
        fail(f"recompute: {it} iterations, converged {rep.converged}")
    if not rep.true_residual < 1e-3:
        fail(f"recompute: true residual {rep.true_residual:.3e}")
    if k3_solve <= 0 or k3_solve != k3_apply * applies:
        fail(f"recompute: {k3_solve} K3 launches in the solve window, want "
             f"{k3_apply} x {applies} applies")
    if counts["sweep"] != chunks * applies \
            or counts["sweep_lerp"] != counts["sweep"]:
        fail(f"recompute: {counts['sweep']} sweeps, want {chunks} chunks x "
             f"{applies} applies, all lerp")
    if counts["stencil_matvec"] != it + cycles:
        fail(f"recompute: {counts['stencil_matvec']} stencil launches")
    if not peak < stored_peak:
        fail(f"recompute: peak {peak} not below the stored path's "
             f"{stored_peak}")


def check_recompute_multi(recs, counts, peak, k3_setup, k3_solve, k3_apply,
                          fwd_bwd):
    """The batched GMRES's applies (`batched_launches`), each walking the
    chunk sweeps at its width and re-factoring every chunk ONCE for the
    batch: K3 per apply equals the single-RHS path's."""
    say("recompute_multi", records=[{k: r[k] for k in (
        "wave_num", "iterations", "converged", "true_residuals",
        "init_time_s", "solve_time_s")} for r in recs],
        peak_memory_bytes=peak, k3_launches_solve_window=k3_solve,
        k3_launches_setup=counts["gj_inverse"] - k3_solve,
        k3_launches_setup_alone=k3_setup, launches=counts)
    [r] = recs
    if not all(r["converged"]) or max(r["iterations"]) > MAX_ITERS_BATCHED:
        fail(f"recompute_multi: {r['iterations']}, {r['converged']}")
    if not all(x < 1e-3 for x in r["true_residuals"]):
        fail(f"recompute_multi: true residuals {r['true_residuals']}")
    products, applies_by_key = batched_launches([r["iterations"]], True)
    applies = sum(c for k, c in applies_by_key.items()
                  if k.startswith("fwd"))
    want = {k: c * fwd_bwd[0 if k.startswith("fwd") else 1]
            for k, c in applies_by_key.items()}
    if counts["sweep_variants"] != want:
        fail(f"recompute_multi: sweeps {counts['sweep_variants']}, want "
             f"{want}")
    if counts["stencil_matvec"] != products:
        fail(f"recompute_multi: {counts['stencil_matvec']} stencil "
             f"launches, want {products}")
    if k3_solve != k3_apply * applies:
        fail(f"recompute_multi: {k3_solve} K3 launches for {applies} "
             f"applies; the single-RHS apply makes {k3_apply}")


def checkpoint_phase(out_dir):
    """At n = 255 on the card: build, save, load (the loaded state's apply
    equal to the bit), then resumable GMRES(2) stopped after its first
    checkpoint and resumed in a second call, against one uninterrupted
    GMRES(2): the same count and x to the bit (both run the same kernels
    on the same inputs in the same order)."""
    paths = [os.path.join(out_dir, name) for name in
             ("checkpoint_P.npz", "checkpoint_krylov.npz")]
    kw = dict(restart=2, rtol=1e-5)

    def run():
        P, A, f = ht.build_preconditioner(
            SMALL_255["n"], SMALL_255["b"], SMALL_255["wave_num"],
            SMALL_255["const"])
        t0 = time.perf_counter()
        checkpoint.save_preconditioner(paths[0], P)
        P2 = checkpoint.load_preconditioner(paths[0])
        io_s = time.perf_counter() - t0
        v = f.reshape(-1)
        same_apply = torch.equal(P(v), P2(v))
        mv = lambda x: k1.stencil_matvec_flat(A, x)       # noqa: E731
        ref = ht.gmres(mv, v, M=P2, maxiter=60, **kw)
        if os.path.exists(paths[1]):
            os.remove(paths[1])
        part = resumable_gmres(mv, v, M=P2, checkpoint_path=paths[1],
                               maxiter=2, **kw)
        full = resumable_gmres(mv, v, M=P2, checkpoint_path=paths[1],
                               maxiter=60, **kw)
        return same_apply, ref, part, full, io_s

    (same_apply, ref, part, full, io_s), counts, peak = counted(run)
    file_bytes = os.path.getsize(paths[0])
    for path in paths:
        os.remove(path)
    say("checkpoint", n=SMALL_255["n"], file_bytes=file_bytes,
        save_load_s=io_s, apply_bits_equal=same_apply,
        iterations=ref.iterations, first_call_iterations=part.iterations,
        resumed_iterations=full.iterations,
        x_bits_equal=torch.equal(full.x, ref.x), peak_memory_bytes=peak,
        launches=counts)
    if not same_apply:
        fail("checkpoint: the loaded state's apply differs")
    if not (ref.converged and ref.iterations > 2 and part.iterations == 2
            and not part.converged):
        fail(f"checkpoint: uninterrupted {ref.iterations} iterations, first "
             f"call {part.iterations}: no restart boundary was crossed")
    if full.iterations != ref.iterations or not torch.equal(full.x, ref.x):
        fail(f"checkpoint: resumed {full.iterations} iterations against "
             f"{ref.iterations}, x equal {torch.equal(full.x, ref.x)}")
    check_setup_launches("checkpoint", counts)
    return counts


def roofline_paths():
    """`bench.roofline`'s measures of the solver's three parts at n = 1023,
    against the peaks measured at the start of this run."""
    pk = {"read_gb_s": PEAKS["read_bytes_per_s"] / 1e9,
          "stream_gb_s": PEAKS["streaming_bytes_per_s"] / 1e9,
          "matmul_tflops": PEAKS["f32_flops"] / 1e12}
    n, b = FULL["n"], FULL["b"]
    rec = {"spmv": roofline.measure_spmv(n, peaks=pk),
           "setup": roofline.measure_setup(n, b, peaks=pk),
           "sweep": roofline.measure_sweep(n, b, peaks=pk)}
    torch.cuda.empty_cache()
    say("roofline_paths", **rec)
    # a share of a peak above 1 means the model counts traffic or work
    # that the call did not do (such as operands served from the L2
    # cache); the setup's JAX-model share counts each inverse's work
    # twice, so its own-count `_gj` share is the one held to 1
    shares = {"spmv": ("roofline_fraction", "roofline_fraction_measured"),
              "setup": ("roofline_fraction_gj",
                        "roofline_fraction_gj_measured",
                        "expand_fraction", "expand_fraction_measured"),
              "sweep": ("roofline_fraction", "roofline_fraction_measured")}
    for part, r in rec.items():
        for key in ("roofline_fraction", "roofline_fraction_measured"):
            if not (math.isfinite(r[key]) and 0 < r[key]):
                fail(f"roofline_paths: {part} {key} = {r[key]}")
        for key in shares[part]:
            if r[key] is not None and not 0 < r[key] <= 1.05:
                fail(f"roofline_paths: {part} {key} = {r[key]} is not a "
                     "share of the peak")
    return rec


def profile_phases(out_dir):
    """An n = 255 run_solver inside `utils.profiling.trace`: the exported
    trace must hold the driver's assemble, factor and solve phases."""
    tdir = os.path.join(out_dir, "trace_n255")
    with profiling.trace(tdir):
        rep = ht.run_solver(SMALL_255["n"], SMALL_255["b"],
                            SMALL_255["wave_num"], SMALL_255["const"])
    path = os.path.join(tdir, "trace.json")
    with open(path) as fh:
        events = json.load(fh)["traceEvents"]
    size = os.path.getsize(path)
    os.remove(path)
    names = {e.get("name") for e in events}
    found = sorted(names & {"assemble", "factor", "solve"})
    kernels = sum(1 for e in events if e.get("cat") == "kernel")
    say("profile_phases", iterations=rep.iterations, trace_bytes=size,
        events=len(events), device_kernel_events=kernels, phases=found)
    if found != ["assemble", "factor", "solve"]:
        fail(f"profile_phases: the trace holds the phases {found}")
    if not rep.converged:
        fail("profile_phases: the solve did not converge")



# -- the flagship scale, the accuracy study, the command line ----------------

def flagship_phases(out_dir, paths, record):
    """n = 2047 through the normal entry points: the single solve over
    compressed and over dense G, the batched two-frequency sweep, and the
    9-point batched sweep through the command line's `main` in this process
    (so the launch counts read it).  A failure of any of them fails the
    run; nothing here falls back."""
    for name, cfg in (("flagship", FLAG), ("flagship_dense", FLAG_DENSE)):
        rep, counts, peak = counted_solve(cfg, name)
        check_solve(name, cfg, rep, counts, peak, max_iters=MAX_ITERS_FLAG,
                    lerp=cfg["g_compress"])
        if rep.config["factor_stride"] != FLAG_STRIDE:
            fail(f"{name}: auto stride {rep.config['factor_stride']}, "
                 f"expected {FLAG_STRIDE}")
        paths[name] = counts
        record[name] = rep.metrics()
        record[f"{name}_peak_bytes"] = peak
        del rep
        torch.cuda.empty_cache()
    cfg = FLAG_MULTI
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    recs, counts, peak = counted(lambda: ht.run_multisolve(
        FLAG["n"], FLAG["b"], cfg["wave_nums"], **kw), "flagship_multi")
    check_multisolve("flagship_multi", cfg, recs, counts, peak, True,
                     max_iters=MAX_ITERS_FLAG, n=FLAG["n"])
    paths["flagship_multi"] = counts
    record["flagship_multi"] = recs
    torch.cuda.empty_cache()
    metrics = os.path.join(out_dir, "flagship9.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    # the command prints each record too; the phase line below carries it
    with contextlib.redirect_stdout(io.StringIO()):
        rc, counts, peak = counted(
            lambda: cli.main(FLAG9_ARGV + ["--metrics", metrics]),
            "flagship9")
    with open(metrics) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    if rc != 0:
        fail(f"flagship9: the command exited {rc}")
    check_multisolve("flagship9", FLAG9, recs, counts, peak, True, tri=True,
                     max_iters=MAX_ITERS_FLAG9, n=FLAG9["n"])
    paths["flagship9"] = counts
    record["flagship9"] = recs
    torch.cuda.empty_cache()


def accuracy_phase():
    """`bench.accuracy`'s refine study on the card (complex64, ir-df32):
    n = 63, 127, 255 at omega/2pi = 8 on both stencils, held to the bounds
    of the JAX package's own accuracy test."""
    def run():
        rows = []
        for n in ACCURACY_NS:
            for stencil in ("5pt", "9pt"):
                rec = measure_error(n, ACCURACY_WAVE_NUM, stencil)
                rec["study"] = "refine"
                rows.append(rec)
        return rows

    rows, counts, peak = counted(run)
    orders = convergence_orders(rows)
    err = {(r["stencil"], r["n"]): r["err_rel_interior"] for r in rows}
    say("accuracy", rows=rows, convergence_orders=orders,
        peak_memory_bytes=peak, launches=counts)
    if not all(r["converged"] for r in rows):
        fail(f"accuracy: not converged: {[r['converged'] for r in rows]}")
    if not 1.6 < orders["5pt"][0] < 2.4:
        fail(f"accuracy: 5-point order {orders['5pt']}")
    if not orders["9pt"][0] > 3.4:
        fail(f"accuracy: 9-point order {orders['9pt']}")
    for n in ACCURACY_NS[:2]:
        if not err[("9pt", n)] < err[("5pt", n)] / 20:
            fail(f"accuracy: at n = {n} the 9-point error "
                 f"{err[('9pt', n)]:.3e} is not 20x below the 5-point "
                 f"{err[('5pt', n)]:.3e}")
    # ir-df32 restarts its inner solves: the launches are bounded below
    want = {variant_key(m, 1, False, tri) for m in ("fwd", "bwd")
            for tri in (False, True)}
    if counts["stencil_matvec"] < 1 or set(counts["sweep_variants"]) != want:
        fail(f"accuracy: launches {counts}")
    check_setup_launches("accuracy", counts)
    return rows, orders, counts


def cli_phase(out_dir):
    """`python -m helmholtz_tpu_torch solve` at ORACLE.json's n = 127
    configuration in a subprocess (its exit code, its iteration line, its
    metrics), the same arguments through `cli.main` in this process with
    the launches counted, and `plan --n 2047 --stencil 9pt` on the card."""
    root = os.path.dirname(os.path.abspath(__file__))
    metrics = os.path.join(out_dir, "cli_solve.jsonl")
    counted_metrics = os.path.join(out_dir, "cli_solve_counted.jsonl")
    for path in (metrics, counted_metrics):
        if os.path.exists(path):
            os.remove(path)
    t0 = time.perf_counter()
    proc = subprocess.run(
        [sys.executable, "-m", "helmholtz_tpu_torch", *CLI_SOLVE,
         "--metrics", metrics], cwd=root, capture_output=True, text=True,
        timeout=600)
    wall = time.perf_counter() - t0
    if proc.returncode != 0:
        fail(f"cli_main: exit {proc.returncode}: {proc.stderr[-2000:]}")
    with open(metrics) as fh:
        rec = json.loads(fh.read().strip().splitlines()[-1])
    line = next((l for l in proc.stdout.splitlines()
                 if l.startswith("GMRES iterations")), None)
    if (line is None or not rec["converged"]
            or rec["iterations"] > MAX_ITERS_CLI
            or not rec["device"].startswith("cuda")):
        fail(f"cli_main: {line!r}, metrics {rec}")
    with contextlib.redirect_stdout(io.StringIO()):
        rc, counts, peak = counted(lambda: cli.main(
            [*CLI_SOLVE, "--metrics", counted_metrics]))
    with open(counted_metrics) as fh:
        rec_in = json.loads(fh.read().strip().splitlines()[-1])
    it = rec_in["iterations"]
    # one restart cycle: it + 1 products, it + 2 applies (see check_solve)
    want = {variant_key(m, 1, False): it + 2 for m in ("fwd", "bwd")}
    if rc != 0 or counts["stencil_matvec"] != it + 1 \
            or counts["sweep_variants"] != want:
        fail(f"cli_main in process: exit {rc}, {it} iterations, launches "
             f"{counts}")
    check_setup_launches("cli_main", counts)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc_plan = cli.main(["plan", "--n", "2047", "--stencil", "9pt"])
    plan9 = json.loads(buf.getvalue())
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    if (rc_plan != 0 or plan9["b"] != 147 or not plan9["fits_single_chip"]
            or plan9["hbm_gb"] != card_gb):
        fail(f"cli_main plan: exit {rc_plan}, {plan9}")
    out = {"exit_code": proc.returncode, "iteration_line": line,
           "metrics": rec, "subprocess_wall_s": wall,
           "in_process_iterations": it, "in_process_peak_bytes": peak,
           "plan_9pt_2047": plan9}
    say("cli_main", **out, launches=counts)
    return counts, out


# -- the other problems, a wide batch, n = 2047 --------------------------------

def oracle_problem_iters(problem, n, rtol=1e-3, impl="scipy"):
    """The complex128 reference count for one problem at grid size n, as
    `scripts/oracle_problems.py` wrote it: the scipy oracle's
    (ORACLE_PROBLEMS.jsonl) or the port's own CPU solve's
    (PORT_REFERENCE_n2047.jsonl)."""
    want = f"{oracle_problems.metric(problem, n, impl)}_rtol{rtol:g}"
    name = ORACLE_PROBLEMS if impl == "scipy" else PORT_REFERENCE
    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), name)
    with open(path) as fh:
        row = next((r for r in map(json.loads, filter(str.strip, fh))
                    if r["metric"] == want), None)
    if row is None or row["info"] != 0:
        fail(f"{name}: no converged row {want}: {row}")
    return row["iters"]


def problems_phase(paths, record):
    """run_solver at the main configuration for c1_f2, c2_f1 and c2_f2:
    c1_f2 over the stride-7 setup, each c2 medium over its one factored
    subgrid (`dedup_hm`), whose one panel every sweep shares."""
    for problem in PROBLEMS:
        name = f"problem_{problem}"
        cfg = dict(FULL, problem=problem)
        shared = problem in ROW_INVARIANT
        oracle = oracle_problem_iters(problem, cfg["n"])
        rep, counts, peak = counted_solve(cfg, name)
        check_solve(name, cfg, rep, counts, peak, max_iters=oracle + 1,
                    shared=shared)
        got = (rep.config["dedup_hm"], rep.config["factor_stride"])
        if got != (shared, 1 if shared else LERP_STRIDE):
            fail(f"{name}: dedup_hm and stride {got}")
        paths[name] = counts
        record[name] = {**rep.metrics(), "oracle_iters": oracle}
        record[f"{name}_peak_bytes"] = peak
        del rep
        torch.cuda.empty_cache()


def cli_sweep_phase(out_dir):
    """The command line's `sweep`, the reference's experiment harness, on
    c2_f2 over n = 127 ... 1023 through `cli.main` in this process: exit 0;
    every solve converged, on the card, over one shared float32 panel, with
    the launches its count implies; at n = 511 and 1023 at most the
    oracle's count + 1."""
    metrics = os.path.join(out_dir, "cli_sweep.jsonl")
    if os.path.exists(metrics):
        os.remove(metrics)
    with contextlib.redirect_stdout(io.StringIO()) as buf:
        rc, counts, peak = counted(
            lambda: cli.main(CLI_SWEEP + ["--metrics", metrics]),
            "cli_sweep")
    with open(metrics) as fh:
        recs = [json.loads(line) for line in fh if line.strip()]
    if rc != 0 or [r["n"] for r in recs] != list(CLI_SWEEP_NS):
        fail(f"cli_sweep: exit {rc}, sizes {[r['n'] for r in recs]}")
    products = applies = 0
    limits = {}
    for r in recs:
        what = f"cli_sweep n={r['n']}"
        if (not r["converged"] or not r["true_residual"] < 1e-3
                or r["iterations"] > 20 or not r["dedup_hm"]
                or not r["device"].startswith("cuda")):
            fail(f"{what}: {r}")
        if r["n"] in (511, 1023):
            limits[r["n"]] = oracle_problem_iters("c2_f2", r["n"]) + 1
            if r["iterations"] > limits[r["n"]]:
                fail(f"{what}: {r['iterations']} iterations > "
                     f"{limits[r['n']]}")
        # one restart cycle: it + 1 products, it + 2 applies (check_solve)
        products += r["iterations"] + 1
        applies += r["iterations"] + 2
    want = {variant_key(m, 1, False, shared=True): applies
            for m in ("fwd", "bwd")}
    if (counts["stencil_matvec"] != products
            or counts["sweep_variants"] != want):
        fail(f"cli_sweep: launches {counts}, want {products} products and "
             f"{want}")
    check_setup_launches("cli_sweep", counts)
    out = {"exit_code": rc, "lines": [l for l in buf.getvalue().splitlines()
                                      if l.startswith("n=")],
           "limits": limits, "peak_memory_bytes": peak,
           "records": [{k: r[k] for k in (
               "n", "wave_num", "const", "iterations", "true_residual",
               "init_time_s", "solve_time_s", "factor_stride")}
               for r in recs]}
    say("cli_sweep", **out, launches=counts)
    return counts, out


def wide_batch_phase(dev):
    """run_multisolve with eight sources of c1_f2 over compressed G, which
    the wide kernel does not take: each sweep of more than four right-hand
    sides runs in launches of at most four (`sweep_widths`).  Then the same eight sources on the same operator and
    preconditioner (`driver`'s own stages), through solve_multi_rhs once
    as eight and once as two batches of four: the lockstep GMRES keeps each
    member's state, so the counts must be equal and the solutions agree;
    and one apply of the eight makes 2 x ceil(8/4) launches."""
    n, b = FULL["n"], FULL["b"]
    cfg = WIDE
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    recs, counts, peak = counted(lambda: ht.run_multisolve(
        n, b, cfg["wave_nums"], **kw), "wide_batch")
    check_multisolve("wide_batch", cfg, recs, counts, peak, True)
    [rec] = recs
    wn, C, K = cfg["wave_nums"][0], cfg["consts"][0], cfg["n_sources"]
    stage = dict(n=n, b=b, problem=cfg["problem"], fidelity="corrected",
                 cdtype=torch.complex64, device=dev)
    A, hm, _ = ht_driver._assemble_stage(wn, C, 2.0, **stage)
    P = ht_driver._factor_stage(
        A, hm, b=b, hf_full_coupling=True, d2_replace=True,
        setup_chunk=sweeping.DEFAULT_SETUP_CHUNK, g_dtype=cfg["g_dtype"],
        factor_stride=cfg["factor_stride"], g_compress=True, device=dev)
    del hm
    r1s = np.linspace(0.2, 0.8, K).astype(np.float32)
    F = ht_driver._sources_stage(
        wn, 2.0, r1s, np.full((K,), 0.125, np.float32), n=n,
        problem=cfg["problem"], cdtype=torch.complex64,
        device=dev).reshape(K, -1)
    _, apply_counts, _ = counted(lambda: P.apply_multi(F))
    want = {}
    for w in sweep_widths(K, True):
        for m in ("fwd", "bwd"):
            want[variant_key(m, w, True)] = want.get(
                variant_key(m, w, True), 0) + 1
    if apply_counts["sweep_variants"] != want:
        fail(f"wide_batch: one apply of {K} launched "
             f"{apply_counts['sweep_variants']}, want {want}")
    one = ht_driver._matvec_of(A)

    def solve(Fb):
        return solve_multi_rhs(lambda V: torch.stack([one(v) for v in V]),
                               Fb.contiguous(), M=P.apply_multi,
                               restart=20, rtol=cfg["rtol"], maxiter=200,
                               device=dev)

    whole = solve(F)
    halves = [solve(F[:K // 2]), solve(F[K // 2:])]
    its = np.asarray(whole.iterations).tolist()
    its_halves = [int(i) for h in halves for i in h.iterations]
    x_halves = torch.cat([h.x for h in halves])
    x_rel = [((whole.x[k] - x_halves[k]).norm() / x_halves[k].norm()).item()
             for k in range(K)]
    A_np, X, F_np = A.to_numpy(), whole.x.cpu().numpy(), F.cpu().numpy()
    true_res = [float(np.linalg.norm(
        ht_driver._host_matvec_any(A_np, X[k].reshape(n, n)).ravel()
        - F_np[k]) / np.linalg.norm(F_np[k])) for k in range(K)]
    out = {"records": [{k: rec[k] for k in (
               "iterations", "converged", "true_residuals", "init_time_s",
               "solve_time_s", "factor_stride", "g_bytes_at_rest")}],
           "peak_memory_bytes": peak, "apply_launches": apply_counts,
           "iterations_eight": its, "iterations_two_fours": its_halves,
           "x_rel_eight_vs_fours": x_rel, "x_tol": WIDE_X_TOL,
           "true_residuals_eight": true_res}
    say("wide_batch_compare", **out)
    if its != its_halves or not all(whole.converged):
        fail(f"wide_batch: counts {its} as eight, {its_halves} as 4 + 4")
    if any(abs(a - c) > 1 for a, c in zip(rec["iterations"], its)):
        fail(f"wide_batch: run_multisolve counts {rec['iterations']}, the "
             f"same sources on its stages {its} (+-1)")
    if not max(x_rel) <= WIDE_X_TOL:
        fail(f"wide_batch: eight against 4 + 4 differ by {max(x_rel):.3e}")
    if not max(true_res) < 1e-3:
        fail(f"wide_batch: true residuals {true_res}")
    del A, P, F, whole, halves
    torch.cuda.empty_cache()
    return counts, out


def wide_dense_phase():
    """run_multisolve with sixteen sources over the dense bf16 stack at the
    main configuration: every apply wider than four is ONE wide launch a
    direction, at each width the lockstep batch passes through, the
    stragglers' narrower ones the narrow kernel's (`check_multisolve`
    derives the launches from the iteration lists through
    `sweep_widths`)."""
    n, b = FULL["n"], FULL["b"]
    cfg = WIDE_DENSE
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    recs, counts, peak = counted(lambda: ht.run_multisolve(
        n, b, cfg["wave_nums"], **kw), "wide_dense")
    check_multisolve("wide_dense", cfg, recs, counts, peak, False)
    torch.cuda.empty_cache()
    return counts, recs


def flagship_problems_phase(paths, record, dev):
    """n = 2047 (b = 12, omega/2pi = 256, C = 100, bf16 G) for c2_f1, whose
    one shared 2047^2 panel every sweep reads (limit: the port's complex128
    CPU count + 1), and for c1_f2 over compressed G at stride 8 (no
    reference count: c1_f1's limit).  Then the shared panel's launch plan:
    sixteen rows a block, and one stage of them in shared memory in bf16
    (none would fit in float32)."""
    for name, cfg in FLAG_PROBLEMS.items():
        shared = cfg["problem"] in ROW_INVARIANT
        limit = (oracle_problem_iters(cfg["problem"], cfg["n"], impl="port")
                 + 1 if shared else MAX_ITERS_FLAG)
        rep, counts, peak = counted_solve(cfg, name)
        check_solve(name, cfg, rep, counts, peak, max_iters=limit,
                    lerp=not shared, shared=shared)
        got = (rep.config["dedup_hm"], rep.config["factor_stride"])
        if got != (shared, 1 if shared else FLAG_STRIDE):
            fail(f"{name}: dedup_hm and stride {got}")
        paths[name] = counts
        record[name] = {**rep.metrics(), "limit": limit}
        record[f"{name}_peak_bytes"] = peak
        del rep
        torch.cuda.empty_cache()
    plans = {t: dataclasses.asdict(k2.launch_plan(
        FLAG["n"], 1, size, False, True, k2._sm_count(dev)))
        for t, size in (("bf16", 2), ("f32", 4))}
    record["flagship_shared_plan"] = plans
    say("flagship_shared_plan", **plans)
    if (plans["bf16"]["rows_per_block"], plans["bf16"]["stages"]) != (16, 1):
        fail(f"the n = 2047 shared bf16 panel's plan {plans['bf16']}")


def amortized_plan(n, stride):
    """bench.plan's peak of a four-source amortized sweep over compressed G
    at `stride`, and what it holds besides while it factors the next
    anchor: the previous anchor's stack, H_F stack and operator."""
    p = capacity.plan(n, 12, 4, g_dtype="bf16", g_compress_stride=stride)
    return p, p["g_stack_gb"] + p["tf_stack_gb"] + 5 * n ** 2 * 8 / 1e9


def flagship_amortized_phase(paths, record):
    """MULTISOLVE_AMORTIZED_n2047.jsonl's run (the JAX package ran out of
    memory re-running it): four frequencies at n = 2047 over compressed G
    at stride 16, four sources, an anchor every third frequency.  The
    planner first: its peak with the held anchor must fit the card.  Each
    source within the record's count + 1."""
    n, b = FLAG["n"], FLAG["b"]
    cfg = FLAG_AMORTIZED
    p, held = amortized_plan(n, cfg["factor_stride"])
    card_gb = torch.cuda.get_device_properties(0).total_memory / 1e9
    if not p["peak_gb"] + held < 0.92 * card_gb:
        fail(f"flagship_amortized: the planner's {p['peak_gb'] + held:.2f} "
             f"GB does not fit the card's {card_gb:.2f} GB")
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    recs, counts, peak = counted(lambda: ht.run_multisolve(
        n, b, cfg["wave_nums"], **kw), "flagship_amortized")
    check_multisolve("flagship_amortized", cfg, recs, counts, peak, True,
                     ["factor", "omega_lerp", "omega_lerp", "factor"],
                     max_iters=MAX_ITERS_FLAG, n=n)
    for r, ref in zip(recs, FLAG_AMORTIZED_ITERS, strict=True):
        if any(i > j + 1 for i, j in zip(r["iterations"], ref, strict=True)):
            fail(f"flagship_amortized at {r['wave_num']}: {r['iterations']}"
                 f", the record {ref} (+1)")
    paths["flagship_amortized"] = counts
    record["flagship_amortized"] = recs
    record["flagship_amortized_plan_gb"] = p["peak_gb"] + held
    torch.cuda.empty_cache()


# -- the distributed path -------------------------------------------------------

def rank_counts(rank_launches):
    """The launches of every rank of a record, summed, in `counted`'s form
    (the sweeps by `variant_key`)."""
    out = {"stencil_matvec": 0, "sweep": 0, "gj_inverse": 0,
           "bsr_matmat": 0, "sweep_variants": {}}
    for c in rank_launches:
        for k in ("stencil_matvec", "sweep", "gj_inverse"):
            out[k] += c[k]
        for key, n in c["sweep_variants"].items():
            mode, width, lerp, tri, shared = key.split(",")
            v = variant_key(mode, int(width), lerp == "True", tri == "True",
                            shared == "True")
            out["sweep_variants"][v] = out["sweep_variants"].get(v, 0) + n
    return out


def add_counts(total, counts):
    for k in ("stencil_matvec", "sweep", "gj_inverse", "bsr_matmat"):
        total[k] = total.get(k, 0) + counts[k]
    variants = total.setdefault("sweep_variants", {})
    for v, n in counts["sweep_variants"].items():
        variants[v] = variants.get(v, 0) + n
    return total


def check_rank_launches(name, rank_launches, five_point):
    """Each rank of one record: K3 under its setup, one K2 launch a
    direction for every sweep chunk of its applies, and on the 5-point
    scheme one K1 launch for every complex64 band product (none on the
    9-point scheme, whose product is plain tensor code)."""
    chunks = {c["apply_chunks"] for c in rank_launches}
    if len(rank_launches) != DIST_RANKS or len(chunks) != 1 or 0 in chunks:
        fail(f"{name}: the ranks' applies differ or are missing: "
             f"{rank_launches}")
    for r, c in enumerate(rank_launches):
        if c["gj_inverse"] < 1:
            fail(f"{name}: rank {r} launched no Gauss-Jordan kernel")
        if c["sweep"] != 2 * c["apply_chunks"]:
            fail(f"{name}: rank {r} made {c['sweep']} sweep launches for "
                 f"{c['apply_chunks']} sweep chunks of applies")
        want = c["band_products"] if five_point else 0
        if c["stencil_matvec"] != want or (five_point and want < 1):
            fail(f"{name}: rank {r} made {c['stencil_matvec']} stencil "
                 f"launches for {c['band_products']} band products")


def dist_multisolve_phase(name, out_dir):
    """One distributed phase: the call across DIST_RANKS ranks on the card,
    then the same call on one card in this process.  Returns (the summed
    counts of the ranks, the phase's record)."""
    n, b, cfg, max_iters, res_below = DIST_PHASES[name]
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    nine = kw.get("stencil") == "9pt"
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    if name == "dist_flagship":
        metrics = os.path.join(out_dir, "dist_flagship.jsonl")
        if os.path.exists(metrics):
            os.remove(metrics)
        with contextlib.redirect_stdout(io.StringIO()):
            rc = cli.main(DIST_FLAG_ARGV + ["--mesh", str(DIST_RANKS),
                                            "--metrics", metrics])
        if rc != 0:
            fail(f"{name}: the command exited {rc}")
        with open(metrics) as fh:
            recs = [json.loads(line) for line in fh if line.strip()]
    else:
        recs = ht.run_multisolve(n, b, cfg["wave_nums"],
                                 mesh_devices=DIST_RANKS, **kw)
    t_dist = time.perf_counter() - t0
    t0 = time.perf_counter()
    single, counts1, peak1 = counted(lambda: ht.run_multisolve(
        n, b, cfg["wave_nums"], **kw), name + "_single")
    t_single = time.perf_counter() - t0
    total = {}
    for rec, ref in zip(recs, single, strict=True):
        what = f"{name} at {rec['wave_num']}"
        if (rec["mesh_devices"], rec["ranks_per_card"],
                rec["dist_backend"]) != (DIST_RANKS, DIST_RANKS, "gloo"):
            fail(f"{what}: ran as {rec['mesh_devices']} ranks, "
                 f"{rec['ranks_per_card']} a card, {rec['dist_backend']}")
        if rec.get("setup_mode") != ref.get("setup_mode"):
            fail(f"{what}: setup mode {rec.get('setup_mode')}, one card "
                 f"{ref.get('setup_mode')}")
        if not all(rec["converged"]):
            fail(f"{what}: not converged: {rec['converged']}")
        if max(rec["iterations"]) > max_iters:
            fail(f"{what}: iterations {rec['iterations']} > {max_iters}")
        if any(abs(a - c) > 1 for a, c in zip(rec["iterations"],
                                              ref["iterations"])):
            fail(f"{what}: iterations {rec['iterations']}, one card "
                 f"{ref['iterations']} (+-1)")
        if not all(r < res_below for r in rec["true_residuals"]):
            fail(f"{what}: true residuals {rec['true_residuals']}")
        check_rank_launches(what, rec["rank_launches"], not nine)
        add_counts(total, rank_counts(rec["rank_launches"]))
    peaks = [max(r["rank_peak_bytes"][k] for r in recs)
             for k in range(DIST_RANKS)]
    PATH_MEMORY[name] = {"peak_bytes": max(peaks), "base_bytes": 0,
                         "rank_peak_bytes": peaks}
    out = {
        "n": n, "b": b, "ranks": DIST_RANKS, "backend": "gloo",
        "ranks_per_card": DIST_RANKS, "seconds": t_dist,
        "single_card_seconds": t_single,
        "records": [{k: r.get(k) for k in (
            "wave_num", "setup_mode", "iterations", "converged",
            "true_residuals", "init_time_s", "solve_time_s",
            "per_device_g_bytes", "rank_peak_bytes", "rank_launches")}
            for r in recs],
        "single_card": [{k: r.get(k) for k in (
            "wave_num", "setup_mode", "iterations", "true_residuals",
            "init_time_s", "solve_time_s")} for r in single],
        "single_card_peak_bytes": peak1, "launches": total}
    say(name, **out)
    return total, out


def dist_dryrun_phase():
    """`dist.dryrun` at n = 64 on DIST_RANKS ranks: its own checks against
    the single-card legs, and the ranks' launches.  Its 5-point legs sweep
    bf16 G, its 9-point leg float32 G."""
    from helmholtz_tpu_torch.dist import dryrun

    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    try:
        out = dryrun.dryrun_multichip(DIST_RANKS, n=DIST_DRYRUN_N)
    except AssertionError as e:
        fail(f"dist_dryrun: {e}")
    check_rank_launches("dist_dryrun", out["rank_launches"], True)
    total = rank_counts(out["rank_launches"])
    out = {k: v for k, v in out.items() if k != "rank_launches"}
    say("dist_dryrun", seconds=time.perf_counter() - t0, launches=total,
        **out)
    return total, out


#: the grid size of each distributed path, which names its sweeps' band
DIST_PATH_N = {"dist_dryrun": DIST_DRYRUN_N,
               **{k: v[0] for k, v in DIST_PHASES.items()}}


def dist_sweep_name(path, key):
    """The kernel-table name of a distributed path's sweep variant: bf16 G
    but the dry run's 9-point leg (float32)."""
    parts = key.split(",")
    mode, width = parts[0], int(parts[1][1:])
    lerp, tri = "lerp" in parts, "tri" in parts
    bf16 = not (path == "dist_dryrun" and tri)
    return (variant_name(mode, bf16, lerp=lerp,
                         R=None if width == 1 else width, tri=tri,
                         band=DIST_PATH_N[path]), mode, width, lerp, tri,
            bf16)


def check_band_kernels(paths, gen, flush, keep):
    """Each kernel at the shapes the distributed paths gave it, against its
    plain version: K1 on a middle band of each grid size's operator
    (n / 4 rows); K2 for every sweep variant a distributed path launched,
    at its band shape (n / 4 panels, or the band's sample window at the
    stride of the path: 7 at n = 1024, 8 at n = 2048)."""
    dev = flush.device
    recs = []
    for n in sorted(set(DIST_PATH_N.values())):
        rows = torch.arange(n // 4, n // 2, device=dev)
        cfg = ht.HelmholtzConfig(n=n, b=12, wave_num=n / 8.0, const=100.0)
        c_full, _ = ht.problems.PROBLEMS["c1_f1"](
            cfg.omega, n, complex_dtype=torch.complex64, device=dev)
        A = fd_stencil.build_a_stencil_rows(
            rows, n, cfg.b, cfg.const, cfg.eta, cfg.omega, cfg.h, c_full,
            fidelity="corrected", complex_dtype=torch.complex64)
        rec = check_k1(A, gen, None, timed=False)
        say("kernel", name="stencil_matvec", band=True, **rec)
        recs.append(rec)
    seen = set()
    for path in DIST_PATH_N:
        for key in paths.get(path, {}).get("sweep_variants", {}):
            name, mode, width, lerp, tri, bf16 = dist_sweep_name(path, key)
            if name in seen:
                continue
            seen.add(name)
            n = DIST_PATH_N[path]
            n_loc = n // DIST_RANKS
            stride = FLAG_STRIDE if n == DIST_FLAG_N else LERP_STRIDE
            tables = lerp_tables(n_loc, stride, dev) if lerp else None
            panels = int(tables[0].max()) + 2 if lerp else n_loc
            G = random_g(panels, n, gen, dev)
            if bf16:
                G = [g.to(torch.bfloat16) for g in G]
            keep(check_k2(*G, mode, gen, timed=True,
                          R=None if width == 1 else width, tables=tables,
                          tri=tri, band=True))
            del G
            torch.cuda.empty_cache()
    return recs


def plan_check():
    """The capacity planner's peak (`bench.plan`) beside the peak each
    full-width path allocated above what the script already held when the
    path started (its own buffers, such as the 256 MiB cache flush).  The
    amortized sweeps hold the previous anchor's stack, H_F stack and
    operator while they factor the next anchor: that is added to the
    one-frequency plan."""
    def p5(n, batch, **kw):
        return capacity.plan(n, 12, batch, g_dtype="bf16", **kw)

    def p9(n, b, batch, compress, stride):
        return capacity.plan9(n, b, batch, g_dtype="bf16",
                              factor_stride=stride, g_compress=compress)

    n, nF = FULL["n"], FLAG["n"]
    plans = {
        "solve": (p5(n, 1, factor_stride=LERP_STRIDE), 0.0),
        "multisolve": (p5(n, 4, factor_stride=LERP_STRIDE), 0.0),
        "precision": (p5(n, 1, factor_stride=LERP_STRIDE), 0.0),
        "bicgstab": (p5(n, 1, factor_stride=LERP_STRIDE), 0.0),
        "solve9": (p9(n, NINE["b"], 1, False, LERP_STRIDE), 0.0),
        "flagship": (p5(nF, 1, g_compress_stride=FLAG_STRIDE), 0.0),
        "flagship_dense": (p5(nF, 1, factor_stride=FLAG_STRIDE), 0.0),
        "flagship_multi": (p5(nF, 4, g_compress_stride=FLAG_STRIDE), 0.0),
        "flagship9": (p9(nF, FLAG9["b"], 4, True, FLAG_STRIDE), 0.0),
    }
    plans["amortized"] = amortized_plan(n, LERP_STRIDE)
    plans["flagship_amortized"] = amortized_plan(
        nF, FLAG_AMORTIZED["factor_stride"])
    # the other problems: c1_f2 as the main path; the c2 media against the
    # planner's dense stride-1 stack, which does not model their one shared
    # panel (a ratio far below 1 there is the saving, not a fault)
    plans.update({
        "problem_c1_f2": plans["solve"],
        "problem_c2_f1": (p5(n, 1), 0.0), "problem_c2_f2": (p5(n, 1), 0.0),
        "wide_batch": (p5(n, WIDE["n_sources"],
                          g_compress_stride=LERP_STRIDE), 0.0),
        "flagship_c1_f2": plans["flagship"],
        "flagship_c2_f1": (p5(nF, 1), 0.0)})
    multi9 = p9(n, NINE["b"], 4, True, LERP_STRIDE)
    plans["multisolve9"] = (multi9, multi9["g_stack_gb"]
                            + multi9["tf_stack_gb"] + 9 * n ** 2 * 8 / 1e9)
    for name, (nd, b, cfg, _, _) in DIST_PHASES.items():
        stride = cfg.get("factor_stride") or ht_driver.auto_factor_stride(
            nd, "c1_f1")
        p = capacity.plan_distributed(
            nd, b, DIST_RANKS, stride, "bf16",
            g_compress=bool(cfg.get("g_compress")),
            batch=cfg["n_sources"], stencil=cfg.get("stencil", "5pt"))
        p["n"] = nd
        # an amortized rank holds the bracketing anchors' states (samples,
        # H_F stack, band couplings) while it builds a frequency between
        # them
        fields = 9 if cfg.get("stencil") == "9pt" else 5
        held = (2 * (p["per_device_g_gb"] + p["tf_stack_gb"]
                     + fields * nd * nd // DIST_RANKS * 8 / 1e9)
                if cfg.get("freq_anchor_every", 1) > 1 else 0.0)
        plans[name] = (p, held)
    rows = []
    for path, (p, held) in plans.items():
        mem = PATH_MEMORY[path]
        planned = p["peak_gb"] + held
        measured = (mem["peak_bytes"] - mem["base_bytes"]) / 1e9
        phase = max(p["phase_gb"], key=p["phase_gb"].get)
        rows.append({"path": path, "n": p["n"], "planned_gb": planned,
                     "planned_phase": phase,
                     "anchor_held_gb": held, "measured_gb": measured,
                     "peak_bytes": mem["peak_bytes"],
                     "base_bytes": mem["base_bytes"],
                     "ratio": measured / planned})
    say("plan_check", rows=rows, limit=PLAN_RATIO)
    bad = [r for r in rows if not r["ratio"] <= PLAN_RATIO]
    if bad:
        fail(f"plan_check: measured above {PLAN_RATIO} x planned: {bad}")
    return rows


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

    # the card's peaks, beside which every bound below is stated again
    PEAKS.update(read_bytes_per_s=roofline.measure_read_bw() * 1e9,
                 streaming_bytes_per_s=roofline.measure_streaming_bw() * 1e9,
                 f32_flops=roofline.measure_matmul_tflops() * 1e12)
    say("peaks", read_gb_per_s=PEAKS["read_bytes_per_s"] / 1e9,
        streaming_gb_per_s=PEAKS["streaming_bytes_per_s"] / 1e9,
        f32_matmul_tflop_per_s=PEAKS["f32_flops"] / 1e12,
        published_gb_per_s=PUBLISHED_BYTES_PER_S / 1e9,
        published_f32_tflop_per_s=PUBLISHED_F32_FLOPS / 1e12)

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
    # one shared panel, as the row-invariant c2 media sweep it: float32
    # (the command line's sweep, working precision) and bf16 (run_solver)
    shared16 = [g[:1].contiguous() for g in G16]
    for planes in (shared, shared16):
        for mode in ("fwd", "bwd"):
            keep(check_k2(*planes, mode, gen, timed=True, rows=Mg,
                          library_step=(mode == "bwd")))
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
    # the wide kernel: more than four right-hand sides in one launch
    for planes in (G32, G16):
        check_k2_wide(planes, gen, keep)
    # K2 with tridiagonal coupling at the 9-point path's depth (b = 74: 949
    # sweep rows): every mode x type at R = 1 and R = 4
    Mg9 = n - NINE["b"]
    for planes in (G32, G16):
        for R in (None, 4):
            for mode in k2.MODES:
                keep(check_k2(*(g[:Mg9] for g in planes), mode, gen,
                              timed=True, R=R, tri=True,
                              library_step=(mode == "bwd")))
    del G32, G16, shared, shared16
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

    # K2 at the recompute preconditioner's chunk: the float32 samples of one
    # chunk of sweep rows (128 rows, 21 samples at stride 7) with its
    # chunk-local tables, one to four right-hand sides
    rows_c = max(4, min(128, recompute.AUTO_CHUNK_WORDS // (n * n)))
    offs, g_lo, g_w = recompute.chunk_tables(Mg, LERP_STRIDE, 0, rows_c)
    tables_c = (torch.from_numpy(g_lo).to(dev), torch.from_numpy(g_w).to(dev))
    Sc = random_g(len(offs), n, gen, dev)
    for R in (None, 2, 3, 4):
        for mode in ("fwd", "bwd"):
            keep(check_k2(*Sc, mode, gen, timed=True, R=R, tables=tables_c,
                          chunk=True))
    del Sc

    # every mode x type x kind of stack again at n = 33, for one, for an odd
    # number (3) and for more right-hand sides than one narrow launch
    # carries (5: over dense G with diagonal coupling the wide kernel's one
    # launch, else chunks of 4 + 1)
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

    # K2 at the flagship size, n = 2047: the launch plans the n = 1023
    # checks never reach (no stage of a sample pair fits)
    k2_2047 = check_k2_2047(gen, dev, keep)
    say("k2_2047", variants=k2_2047)

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
            got = sweeping.apply_preconditioner(P, prob.f_grid)
            ref = sweeping.apply_preconditioner(P, prob.f_grid,
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
                    [("fwd", 1, False, True, False),
                     ("bwd" if d2 else "bwd_sub", 1, False, True, False)]):
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
    for rec in rec_inv:
        say("blocked_inverse", **rec)
    rec_routes = check_factor_routes()
    for rec in rec_routes:
        say("factor_routes", **rec)
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
    for (bm, bn), K in K4_RANDOM:
        A_rand = random_bsr(16, 12, bm, bn, gen, dev)
        k4_recs.append(check_k4(A_rand, K, gen, flush, timed=True,
                                library=bsr_as_csr(A_rand)))
        say("kernel", name="bsr_matmat", **k4_recs[-1])
    k4_instances = check_k4_instances(gen, dev)
    say("k4_instances", count=len(k4_instances),
        max_rel_err=max(r["rel_err"] for r in k4_instances), tol=K4_TOL,
        bits_equal=True,
        multi_chunk_cases=sum(r["plan"]["chunks"] > 1 for r in k4_instances),
        instances=[r["instance"] + [r["misaligned"]] for r in k4_instances])

    if args.kernels_only:
        with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as fh:
            json.dump({"nvidia_smi": smi, "kind": kind, "kernels_only": True,
                       "peaks": PEAKS,
                       "stencil_matvec": rec_k1, "sweep_variants": variants,
                       "k2_2047": k2_2047,
                       "gj_inverse": k3_recs, "blocked_inverse": rec_inv,
                       "factor_routes": rec_routes,
                       "bsr_matmat": k4_recs,
                       "bsr_matmat_instances": k4_instances}, fh, indent=1)
        say("done", seconds=time.perf_counter() - t_start, kernels_only=True)
        return

    # the tripwire solve, then the main path at full width
    rep, counts, peak = counted_solve(SMALL)
    check_solve("small_solve", SMALL, rep, counts, peak,
                max_iters=ORACLE_ITERS_SMALL, exact_iters=ORACLE_ITERS_SMALL)
    paths = {}
    rep, counts, peak = counted_solve(FULL, "solve")
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
            n, FULL["b"], cfg["wave_nums"], **kw), name)
        check_multisolve(name, cfg, recs, counts, peak, lerp, modes)
        paths[name] = counts
        record[name] = recs
        record[f"{name}_peak_bytes"] = peak

    # the tight tolerance: refinement in complex128 around the complex64
    # solve, and one refinement step of the preconditioner
    rep, counts, peak = counted_solve(PRECISE, "precision")
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
        rep, counts, peak = counted_solve(cfg, name)
        check_solve(name, cfg, rep, counts, peak, max_iters=limit, **kw)
        paths[name] = counts
        record[name] = rep.metrics()
        record[f"{name}_peak_bytes"] = peak
    cfg = NINE_MULTI
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    recs, counts, peak = counted(lambda: ht.run_multisolve(
        n, NINE["b"], cfg["wave_nums"], **kw), "multisolve9")
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

    # BiCGStab: the main configuration, four sources in lockstep, the
    # 9-point scheme at n = 511
    rep, counts, peak = counted_solve(BICG, "bicgstab")
    check_bicgstab("bicgstab", BICG, rep, counts, peak, MAX_ITERS_BICG)
    paths["bicgstab"] = counts
    record["bicgstab"] = rep.metrics()
    record["bicgstab_peak_bytes"] = peak
    paths["bicgstab_multi"] = bicgstab_multi(gen, dev)
    rep, counts, peak = counted_solve(BICG9)
    check_bicgstab("bicgstab9", BICG9, rep, counts, peak, BICG9["maxiter"])
    paths["bicgstab9"] = counts
    record["bicgstab9"] = rep.metrics()
    torch.cuda.empty_cache()

    # the recompute preconditioner: one apply against the stored one and
    # split, then the solve and the batched solve
    k3_setup, k3_apply, chunks, split = recompute_apply_check(dev)
    record["recompute_apply"] = split
    torch.cuda.empty_cache()
    (rep, k3_solve), counts, peak = counted(
        lambda: k3_in_solve_phases(lambda: solve_with(RECOMPUTE)))
    check_recompute(rep, counts, peak, record["solve_peak_bytes"], k3_setup,
                    k3_solve, k3_apply, chunks)
    paths["recompute"] = counts
    record["recompute"] = rep.metrics()
    record["recompute_peak_bytes"] = peak
    torch.cuda.empty_cache()
    cfg = RECOMPUTE_MULTI
    kw = {k: v for k, v in cfg.items() if k != "wave_nums"}
    (recs, k3_solve), counts, peak = counted(
        lambda: k3_in_solve_phases(lambda: ht.run_multisolve(
            n, FULL["b"], cfg["wave_nums"], **kw)))
    check_recompute_multi(recs, counts, peak, k3_setup, k3_solve, k3_apply,
                          (split["chunks_fwd"], split["chunks_bwd"]))
    paths["recompute_multi"] = counts
    record["recompute_multi"] = recs
    record["recompute_multi_peak_bytes"] = peak
    torch.cuda.empty_cache()

    # checkpoints, the roofline of the parts, the profiled phases
    paths["checkpoint"] = checkpoint_phase(args.out_dir)
    torch.cuda.empty_cache()
    record["roofline_paths"] = roofline_paths()
    profile_phases(args.out_dir)
    torch.cuda.empty_cache()

    # the flagship scale, n = 2047; the accuracy study; the command line;
    # then the planner's peaks beside the measured ones
    flagship_phases(args.out_dir, paths, record)
    record["accuracy"], record["accuracy_orders"], paths["accuracy"] = \
        accuracy_phase()
    paths["cli_main"], record["cli_main"] = cli_phase(args.out_dir)

    # the reference's other three problems at full width, its experiment
    # harness, a batch wider than one launch, and n = 2047 for them
    problems_phase(paths, record)
    paths["cli_sweep"], record["cli_sweep"] = cli_sweep_phase(args.out_dir)
    paths["wide_batch"], record["wide_batch"] = wide_batch_phase(dev)
    paths["wide_dense"], record["wide_dense"] = wide_dense_phase()
    flagship_problems_phase(paths, record, dev)
    flagship_amortized_phase(paths, record)

    # the distributed path: four ranks sharing the card, each phase beside
    # its single-card call; then each kernel at the bands' shapes
    launch.RANK_LIMIT_S = DIST_LIMIT_S
    t_dist = time.perf_counter()
    paths["dist_dryrun"], record["dist_dryrun"] = dist_dryrun_phase()
    for name in DIST_PHASES:
        paths[name], record[name] = dist_multisolve_phase(name,
                                                          args.out_dir)
    record["dist_band_k1"] = check_band_kernels(paths, gen, flush, keep)
    record["dist_seconds"] = time.perf_counter() - t_dist
    record["plan_check"] = plan_check()

    # the kernel table: every kernel variant that a full-width path
    # launched (all with bf16 G and the corrected backward step), with the
    # launches counted during those paths
    by_name = {v["name"]: v for v in variants}
    keys = ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
            "library_ms", "bound_measured_ms")
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
            **{k: rec[k] for k in keys}, "timed_at": shape,
            **{k: rec[k] for k in ("device_ms", "library_device_ms")
               if k in rec}})
    # each path's sweeps by the variant that ran them: bf16 G but on the
    # float32 paths, and the recompute paths' chunk-sized sweeps
    launched = {}
    for path, cs in paths.items():
        for key, c in cs["sweep_variants"].items():
            parts = key.split(",")
            mode, width = parts[0], int(parts[1][1:])
            lerp, tri = "lerp" in parts, "tri" in parts
            if width > k2.MAX_WIDTH and not (lerp or tri or "shared" in parts):
                # every wide launch under the row of the wide kernel's
                # timed width
                width = K2_WIDE_TABLE_R
            if path in DIST_PATH_N:
                name = dist_sweep_name(path, key)[0]
            else:
                name = variant_name(mode, path not in F32_PATHS,
                                    shared="shared" in parts, lerp=lerp,
                                    R=None if width == 1 else width,
                                    tri=tri, chunk=path in CHUNK_PATHS,
                                    big=path in BIG_PATHS)
            by_path = launched.setdefault((name, width, lerp), {})
            by_path[path] = by_path.get(path, 0) + c
    for (name, width, lerp), by_path in launched.items():
        if name not in by_name:
            fail(f"{name} ran on {sorted(by_path)} but was not held against "
                 "its plain version")
        v = by_name[name]
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
            ("exact_residual", ["stencil_matvec", "bsr_matmat"]),
            ("bicgstab", ["stencil_matvec", "sweep_fwd[bf16]",
                          "sweep_bwd[bf16]"]),
            ("bicgstab_multi", ["stencil_matvec", "sweep_fwd[bf16,R4]",
                                "sweep_bwd[bf16,R4]"]),
            ("bicgstab9", ["sweep_fwd[bf16,tri]", "sweep_bwd[bf16,tri]"]),
            ("recompute", ["stencil_matvec", "sweep_fwd[f32,lerp,chunk]",
                           "sweep_bwd[f32,lerp,chunk]"]),
            ("recompute_multi", ["stencil_matvec",
                                 "sweep_fwd[f32,lerp,chunk,R4]",
                                 "sweep_bwd[f32,lerp,chunk,R4]"]),
            ("checkpoint", ["stencil_matvec", "sweep_fwd[f32]",
                            "sweep_bwd[f32]"]),
            ("flagship", ["stencil_matvec", "sweep_fwd[bf16,lerp,n2047]",
                          "sweep_bwd[bf16,lerp,n2047]"]),
            ("flagship_dense", ["stencil_matvec", "sweep_fwd[bf16,n2047]",
                                "sweep_bwd[bf16,n2047]"]),
            ("flagship_multi", ["stencil_matvec",
                                "sweep_fwd[bf16,lerp,R4,n2047]",
                                "sweep_bwd[bf16,lerp,R4,n2047]"]),
            ("flagship9", ["sweep_fwd[bf16,lerp,tri,R4,n2047]",
                           "sweep_bwd[bf16,lerp,tri,R4,n2047]"]),
            ("accuracy", ["stencil_matvec", "sweep_fwd[f32]",
                          "sweep_bwd[f32]", "sweep_fwd[f32,tri]",
                          "sweep_bwd[f32,tri]"]),
            ("cli_main", ["stencil_matvec", "sweep_fwd[f32]",
                          "sweep_bwd[f32]"]),
            ("problem_c1_f2", ["stencil_matvec", "sweep_fwd[bf16]",
                               "sweep_bwd[bf16]"]),
            ("problem_c2_f1", ["stencil_matvec", "sweep_fwd[bf16,shared]",
                               "sweep_bwd[bf16,shared]"]),
            ("problem_c2_f2", ["stencil_matvec", "sweep_fwd[bf16,shared]",
                               "sweep_bwd[bf16,shared]"]),
            ("cli_sweep", ["stencil_matvec", "sweep_fwd[f32,shared]",
                           "sweep_bwd[f32,shared]"]),
            ("wide_batch", ["stencil_matvec", "sweep_fwd[bf16,lerp,R4]",
                            "sweep_bwd[bf16,lerp,R4]"]),
            ("wide_dense", ["stencil_matvec",
                            f"sweep_fwd[bf16,R{K2_WIDE_TABLE_R}]",
                            f"sweep_bwd[bf16,R{K2_WIDE_TABLE_R}]"]),
            ("flagship_c2_f1", ["stencil_matvec",
                                "sweep_fwd[bf16,shared,n2047]",
                                "sweep_bwd[bf16,shared,n2047]"]),
            ("flagship_c1_f2", ["stencil_matvec",
                                "sweep_fwd[bf16,lerp,n2047]",
                                "sweep_bwd[bf16,lerp,n2047]"]),
            ("flagship_amortized", ["stencil_matvec",
                                    "sweep_fwd[bf16,lerp,R4,n2047]",
                                    "sweep_bwd[bf16,lerp,R4,n2047]"]),
            ("dist_dryrun", ["stencil_matvec", "sweep_fwd[bf16,R2,band64]",
                             "sweep_bwd[bf16,R2,band64]",
                             "sweep_fwd[f32,tri,band64]",
                             "sweep_bwd[f32,tri,band64]"]),
            ("dist_multisolve", ["stencil_matvec",
                                 "sweep_fwd[bf16,R4,band1024]",
                                 "sweep_bwd[bf16,R4,band1024]"]),
            ("dist_amortized", ["stencil_matvec",
                                "sweep_fwd[bf16,lerp,R4,band1024]",
                                "sweep_bwd[bf16,lerp,R4,band1024]"]),
            ("dist_precision", ["stencil_matvec", "sweep_fwd[bf16,band1024]",
                                "sweep_bwd[bf16,band1024]"]),
            ("dist9", ["sweep_fwd[bf16,lerp,tri,R4,band1024]",
                       "sweep_bwd[bf16,lerp,tri,R4,band1024]"]),
            ("dist_flagship", ["stencil_matvec",
                               "sweep_fwd[bf16,lerp,R4,band2048]",
                               "sweep_bwd[bf16,lerp,R4,band2048]"])):
        for name in wanted + ([] if path == "exact_residual"
                              else ["gj_inverse"]):
            if names.get(name, {}).get("launches_by_path", {}) \
                    .get(path, 0) < 1:
                fail(f"{name} was not launched by the {path} path")

    seconds = time.perf_counter() - t_start
    with open(os.path.join(args.out_dir, "chip_smoke.json"), "w") as fh:
        json.dump({"nvidia_smi": smi, "kind": kind, "seconds": seconds,
                   "torch": torch.__version__, "cuda": torch.version.cuda,
                   "peaks": PEAKS,
                   "stencil_matvec": rec_k1, "sweep_variants": variants,
                   "gj_inverse": k3_recs, "blocked_inverse": rec_inv,
                   "factor_routes": rec_routes, "bsr_matmat": k4_recs,
                   "bsr_matmat_instances": k4_instances, "kernels": table,
                   "k2_2047": k2_2047, "path_memory": PATH_MEMORY,
                   "launches": paths, **record}, fh, indent=1)
    say("done", seconds=seconds)
    print(json.dumps({"kernels": table}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    main()
