"""Inputs and the timer that `chip_smoke.py` and the measurement scripts
share, so that every script times the kernels on the same data.

Inputs are made on the given device from a seeded `torch.Generator`.
Nothing here builds or launches a kernel by itself.
"""
from __future__ import annotations

import math
import subprocess

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
