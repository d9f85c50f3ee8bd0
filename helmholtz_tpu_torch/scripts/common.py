"""Inputs, timers and bounds that `chip_smoke.py` and the measurement
scripts share, so that every script times the kernels on the same data and
states their bounds alike.

Inputs are made on the given device from a seeded `torch.Generator`.
Nothing here builds or launches a kernel by itself.
"""
from __future__ import annotations

import math
import statistics
import subprocess
import time
import warnings

import numpy as np
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops import dense
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.precond import sweeping


def card() -> str:
    """The card's name and power limit, as `nvidia-smi` prints them."""
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]


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


def host_ms(fn, reps):
    """Median host time of one call of fn() in ms, each call started on an
    idle device: what the call costs the host before it returns."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    torch.cuda.synchronize()
    return statistics.median(times)


# -- bounds ---------------------------------------------------------------------

def bound_ms(bytes_moved, flops, bytes_per_s, flops_per_s):
    """(ms, "bytes" or "operations"): the larger of the bytes over the
    memory rate and the operations over the float32 rate."""
    t_bytes = bytes_moved / bytes_per_s * 1e3
    t_ops = flops / flops_per_s * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops
                                 else "operations")


def rel_err(got, ref):
    """The largest absolute error, and that over the largest entry of ref."""
    scale = ref.abs().max().item()
    err = (got - ref).abs().max().item()
    return err, err / scale


def randc(shape, gen, dev):
    re = torch.randn(shape, generator=gen, device=dev)
    im = torch.randn(shape, generator=gen, device=dev)
    return torch.complex(re, im) / math.sqrt(2.0)


# -- the sweep kernel (K2) ------------------------------------------------------

def sweep_inputs(n, S, R, gen, dev, tri=False):
    """u (S, n) or (S, R, n), c with its top row zero, carry0.  c is (S, n),
    or with `tri` the (S, 3, n) rows [sub, diag, sup] of a tridiagonal
    coupling of about the same norm, with random NON-ZERO values left in
    sub[:, 0] and sup[:, n-1]: the slots that assembly zeroes and that
    neither the kernel nor the plain version may read."""
    shape = (S, n) if R is None else (S, R, n)
    u = randc(shape, gen, dev)
    c = (randc((S, 3, n), gen, dev) / math.sqrt(3.0) if tri
         else randc((S, n), gen, dev))
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
    """(g_lo, g_w) of a stride-`stride` sample stack for M sweep rows."""
    g_w, g_lo = sweeping.compress_tables(M, stride)
    return torch.from_numpy(g_lo).to(dev), torch.from_numpy(g_w).to(dev)


# -- the Gauss-Jordan kernel (K3) and the blocked inverse -----------------------

def gj_matrices(B, k, gen, dev):
    """Random complex64 (B, k, k) matrices that need no pivoting: the
    identity plus a random part of spectral norm about 0.5."""
    eye = torch.eye(k, dtype=torch.complex64, device=dev)
    return eye + randc((B, k, k), gen, dev) * (0.25 / math.sqrt(k))


def schur_blocks(cfg, stride, count):
    """The matrices that the n-point setup inverts at its last layer, S_{b-1}
    = H_{b-1,b-1} - C T_{b-2} C', for the first `count` subgrid samples of a
    stride-`stride` setup of the problem `cfg` (a dict with n, b, wave_num,
    const and problem, as the configurations of `chip_smoke.py`)."""
    n, b = cfg["n"], cfg["b"]
    hc = ht.HelmholtzConfig(n=n, b=b, wave_num=cfg["wave_num"],
                            const=cfg["const"])
    prob = ht.assemble_problem(hc, cfg["problem"])
    rows = b + torch.as_tensor(sweeping.sample_positions(n - b, stride)[
        :count], device=prob.c_full.device)
    hm = fd_stencil.build_hm_stencils_rows(
        rows, n, b, hc.const, hc.eta, hc.omega, hc.h, prob.c_full,
        fidelity="corrected", complex_dtype=torch.complex64)
    T = dense.batched_inverse(sweeping._dense_tridiag(
        hm.cw[:, 0], hm.cc[:, 0], hm.ce[:, 0]))
    for l in range(1, b):
        S = T * (-hm.cs[:, l, :, None])
        S.mul_(hm.cn[:, l - 1, None, :])
        sweeping._add_tridiag_(S, hm.cw[:, l], hm.cc[:, l], hm.ce[:, l])
        if l == b - 1:
            return S
        T = dense.batched_inverse(S)


# -- the block-sparse product (K4) ---------------------------------------------

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


def random_bsr(nbr, nbc, bm, bn, gen, dev, empty=(3,)):
    """A random complex64 BSR matrix with about 40% of its blocks stored and
    the block rows `empty` empty (block 0 of block row 0 stored unless row
    0 is one of them)."""
    rng = np.random.default_rng(int(torch.randint(1 << 30, (1,),
                                                  generator=gen, device=dev)))
    keep = rng.random((nbr, nbc)) < 0.4
    keep[0, 0] = True
    keep[list(empty), :] = False
    br, bc = np.nonzero(keep)
    data = randc((br.shape[0], bm, bn), gen, dev)
    indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
    return ht.BSR(data, torch.as_tensor(bc, dtype=torch.int32, device=dev),
                  torch.as_tensor(indptr, dtype=torch.int32, device=dev),
                  (nbr * bm, nbc * bn), (bm, bn))


def bsr_work(A, K):
    """(bytes, operations) of Y = A X with X of K columns: every stored
    block, X, Y, indices and indptr once; 8 real operations a stored entry
    and column."""
    stored = A.data.numel()
    return (8 * (stored + A.shape[1] * K + A.shape[0] * K)
            + 4 * (A.data.shape[0] + A.indptr.shape[0]), 8 * stored * K)


#: the random shapes every K4 measurement times: (bm, bn) and K, on 16 x 12
#: blocks, about 40% stored, block row 3 empty
K4_RANDOM = [((bm, bn), K) for (bm, bn) in ((64, 64), (128, 128), (48, 80))
             for K in (16, 5, 1)]


def k4_instance(plan):
    """The kernel instance of `csrc/bsr_spmm.cu` that a K4 launch plan
    selects: ("stream", K tile, complex values a load of A, lanes a row) or
    ("tiled", rows a thread, 16-byte copies of A, 16-byte copies of X)."""
    if plan.tiled:
        return ("tiled", plan.lanes, plan.vec == 2, plan.x_vec == 2)
    return ("stream", plan.k_tile, plan.vec, plan.lanes)


_STREAM_BN = {(2, 32): 64, (2, 16): 32, (2, 8): 48,
              (1, 32): 63, (1, 16): 15, (1, 8): 23}

#: every kernel instance the C entry point of K4 dispatches, each with a
#: shape (bm, bn, K) whose plan selects it (`k4_instance`) on 16 x 12 blocks
#: with block rows K4_INSTANCE_EMPTY empty; K pads to the K tile
K4_INSTANCES = (
    [(("stream", kt, v, lpr), (24, _STREAM_BN[(v, lpr)], kt - (kt > 2)))
     for kt in (1, 2, 4, 8) for v in (1, 2) for lpr in (8, 16, 32)]
    + [(("tiled", rm, aw, xw), (96 if rm == 3 else 64, 40 if aw else 41,
                                16 if xw else 17))
       for rm in (2, 3) for aw in (True, False) for xw in (True, False)])
K4_INSTANCE_EMPTY = (0, 3, 15)
