"""The device's measured peaks (streaming and read-only memory rates, the
float32 matrix-product rate) and the roofline of the three parts of the
solver: the stencil product, the setup's phases and one preconditioner
apply.  The kernels' bounds are stated against the card's published peaks;
the bound at the measured ones, stated beside it, says how much of the gap
to a bound the card's reachable rates already explain.

Ported from the JAX package's `bench/roofline.py`: `measure_streaming_bw`,
`measure_read_bw`, `measure_matmul_tflops`, and `measure_spmv`,
`measure_setup` and `measure_sweep` over the port's own path (the stencil
kernel, the blocked Gauss-Jordan setup, the sweep kernel), each returning
the JAX function's dict under its keys.  Their fractions are against the
published peaks (`PUBLISHED_BYTES_PER_S`, `PUBLISHED_F32_FLOPS`), with the
fraction against the measured peak beside each (`..._measured`).

Each peak measure runs one eager torch
call many times: on the card CUDA events time a loop of `iters` calls after
a warm-up call (the host queues these large calls faster than the card
runs them, so the events time the device), on the CPU the host clock does;
the median of three loops is kept.  In eager torch the read reduction is
not hoisted out of the loop, so the reference's trick against XLA (a
reduction that depends on the loop carry) is not needed.
"""
from __future__ import annotations

import statistics
import time

import numpy as np
import torch

from .._device import resolve_device
from .timing import PUBLISHED_BYTES_PER_S, PUBLISHED_F32_FLOPS, device_ms


def _seconds_per_call(fn, iters: int, dev: torch.device) -> float:
    fn()
    cuda = dev.type == "cuda"
    if cuda:
        torch.cuda.synchronize(dev)
    runs = []
    for _ in range(3):
        if cuda:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            for _ in range(iters):
                fn()
            end.record()
            end.synchronize()
            runs.append(start.elapsed_time(end) / 1e3 / iters)
        else:
            t0 = time.perf_counter()
            for _ in range(iters):
                fn()
            runs.append((time.perf_counter() - t0) / iters)
    return statistics.median(runs)


def measure_streaming_bw(mb: int = 256, *, iters: int = 30,
                         device="cuda") -> float:
    """Achievable streaming rate of device memory in GB/s (1e9 bytes): one
    read and one write of an `mb` MiB float32 array a call."""
    dev = resolve_device(device)
    n = mb * 2**20 // 4
    x = torch.ones(n, device=dev)
    y = torch.empty_like(x)
    dt = _seconds_per_call(lambda: torch.mul(x, 1.0000001, out=y), iters,
                           dev)
    return 2 * 4 * n / dt / 1e9


def measure_read_bw(mb: int = 512, *, iters: int = 30,
                    device="cuda") -> float:
    """Achievable read-only rate of device memory in GB/s (1e9 bytes): a
    sum over an `mb` MiB float32 array a call, one float written.
    Read-dominated kernels (the sparse products, the sweep streaming its
    stack of G) are bounded against this, not the copy rate."""
    dev = resolve_device(device)
    n = mb * 2**20 // 4
    x = torch.ones(n, device=dev)
    s = torch.empty((), device=dev)
    dt = _seconds_per_call(lambda: torch.sum(x, 0, out=s), iters, dev)
    return 4 * n / dt / 1e9


def measure_matmul_tflops(n: int = 4096, *, iters: int = 20,
                          device="cuda") -> float:
    """Achievable float32 matrix-product rate in TFLOP/s: an n x n product
    in full float32 (TF32 is off while it is timed, as in every path of
    the port), 2 n^3 operations a call."""
    dev = resolve_device(device)
    a = torch.ones((n, n), device=dev)
    b = torch.full((n, n), 1.0 / n, device=dev)
    c = torch.empty_like(a)
    before = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        dt = _seconds_per_call(lambda: torch.mm(a, b, out=c), iters, dev)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = before
    return 2 * n**3 / dt / 1e12


def _peaks(dev: torch.device, peaks: dict | None) -> dict:
    """The measured peaks, in GB/s and TFLOP/s: `peaks` where the caller
    has them (keys read_gb_s, stream_gb_s, matmul_tflops), else measured
    here (at a few MB on the CPU, where they describe the host)."""
    if peaks is not None:
        return peaks
    cpu = dev.type == "cpu"
    return {"read_gb_s": measure_read_bw(4 if cpu else 512, device=dev),
            "stream_gb_s": measure_streaming_bw(4 if cpu else 256,
                                                device=dev),
            "matmul_tflops": measure_matmul_tflops(128 if cpu else 4096,
                                                   device=dev)}


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def _problem(n: int, b: int, fidelity: str, dev: torch.device):
    """The roofline problem of the JAX package's measures: c1_f1 at
    omega/2pi = 16, C = 81, with its subgrid family."""
    from ..driver import _assemble_stage, default_complex_dtype
    return _assemble_stage(16.0, 81.0, 2.0, n=n, b=b, problem="c1_f1",
                           fidelity=fidelity,
                           cdtype=default_complex_dtype(dev), device=dev)


@torch.no_grad()
def measure_spmv(n: int = 1023, *, iters: int = 50, peaks: dict | None = None,
                 device="cuda") -> dict:
    """Complex stencil product (the stencil kernel on the card) at grid
    size n: rate and roofline fraction.  `s_per_apply` is the device's time
    of one call on the card (`device_ms`: the calls queued behind a sleep
    kernel, so the host's cost of the call is out of it, as the JAX
    package's compiled loop has none; a 256 MiB buffer, five times the L2
    cache, is rewritten before each call, so every call reads its operands
    from device memory), the host clock's on the CPU; `s_per_call_loop` is
    a loop of eager calls, the host's cost included and the cache warm.

    Traffic models, as in the JAX package: 14 real arrays of the working
    float (the five complex coefficient fields, u read and y written: the
    GMRES situation) and 10 (the coefficients alone).  Each eager call here
    reads u from and writes y to device memory, so the 14-array model is
    this loop's real traffic and the fractions are of it: against the
    published rate, and against the measured mix of 12 reads to 2 writes
    (1/W = 2/S - 1/R from the measured streaming and read rates)."""
    from ..ops.kernels.spmv_stencil import stencil_matvec

    dev = resolve_device(device)
    A, _, f = _problem(n, 12, "as-shipped", dev)
    u = f.reshape(n, n)
    call = lambda: stencil_matvec(A, u)                       # noqa: E731
    loop = _seconds_per_call(call, iters, dev)
    if dev.type == "cuda":
        flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
        dt = device_ms(call, iters, flush) / 1e3
        del flush
    else:
        dt = loop
    itemsize = u.real.element_size()
    gb_full = 14 * itemsize * n * n / 1e9
    gb_coeff = 10 * itemsize * n * n / 1e9
    pk = _peaks(dev, peaks)
    bw_read, bw_stream = pk["read_gb_s"], pk["stream_gb_s"]
    inv_w = max(2.0 / bw_stream - 1.0 / bw_read, 1.0 / bw_read)
    peak_full = 14.0 / (12.0 / bw_read + 2.0 * inv_w)
    nnz = 5 * n * n - 4 * n
    return {
        "kernel": "cuda_stencil_spmv" if dev.type == "cuda"
        else "plain_stencil_spmv",
        "n": n,
        "nnz": nnz,
        "s_per_apply": dt,
        "s_per_call_loop": loop,
        "gnnz_per_s": nnz / dt / 1e9,
        "effective_gb_per_s_full_traffic": gb_full / dt,
        "effective_gb_per_s_coeff_traffic": gb_coeff / dt,
        "measured_stream_bw_gb_s": bw_stream,
        "measured_read_bw_gb_s": bw_read,
        "peak_gb_s_coeff_model": bw_read,
        "peak_gb_s_full_model": peak_full,
        "published_gb_s": PUBLISHED_BYTES_PER_S / 1e9,
        "traffic_model": "fraction = full model (14 arrays, 12R:2W: each "
                         "eager call reads u and writes y, L2 flushed "
                         "before each) / published rate; _measured: / "
                         "the measured 12R:2W blend",
        "roofline_fraction": (gb_full / dt) / (PUBLISHED_BYTES_PER_S / 1e9),
        "roofline_fraction_measured": (gb_full / dt) / peak_full,
    }


@torch.no_grad()
def measure_setup(n: int = 1023, b: int = 12, *,
                  factor_stride: int | None = None, g_dtype: str = "bf16",
                  setup_chunk: int | None = None,
                  peaks: dict | None = None, device="cuda") -> dict:
    """Setup-phase breakdown and speed-of-light accounting of the main
    path's setup (c1_f1, corrected), each phase timed warm (the median of
    two runs after one more) on the host's clock, synchronized:

      * assembly: the operator and the whole subgrid family;
      * factor_samples: the batched Schur corner-inverse recursion over the
        strided samples (the blocked Gauss-Jordan, the kernel at its base);
      * expand: the lerp-expansion of the samples to the dense stack;
      * hf: the H_F block-Thomas stack.

    Models: under the JAX package's keys, its count of the recursion's
    flops, Ms * b * (16 n^3 + 8 n^2) (a Gauss-Jordan inverse of an (n, n)
    complex matrix counted as 8 n^3 real MACs, and the row/column
    scaling), which is twice the inverse's own work; under the `_gj` keys
    that work, Ms * b * (8 n^3 + 8 n^2) (n^3 complex multiply-adds of 8
    real flops each), the share to read.  Both against the float32 rate.
    Expand moves the float32 samples read and the dense G written, against
    the memory rate.  Fractions against the published peaks, the measured
    ones beside them."""
    from ..driver import _G_DTYPES, auto_factor_stride
    from ..fd import stencil as fd_stencil
    from ..precond.sweeping import (DEFAULT_SETUP_CHUNK, _schur_t_stack,
                                    expand_strided_samples,
                                    factor_corner_inverses, sample_positions)

    dev = resolve_device(device)
    setup_chunk = setup_chunk or DEFAULT_SETUP_CHUNK
    if factor_stride is None:
        factor_stride = auto_factor_stride(n, "c1_f1", dev)
    R = max(1, factor_stride)
    M = n - b
    pos = sample_positions(M, R) if R > 1 else np.arange(M)
    Ms = len(pos)

    def wall(fn):
        out = fn()
        _sync(dev)
        ts = []
        for _ in range(2):
            del out
            t0 = time.perf_counter()
            out = fn()
            _sync(dev)
            ts.append(time.perf_counter() - t0)
        return statistics.median(ts), out

    t_asm, (A, hm, _) = wall(lambda: _problem(n, b, "corrected", dev))
    wf = hm.cc.real.dtype
    gdt = _G_DTYPES[g_dtype] or wf
    ks = torch.as_tensor(pos, device=dev)
    hm_s = hm.map(lambda f: f[ks]) if R > 1 else hm
    del hm
    t_fac, Ts = wall(lambda: factor_corner_inverses(
        hm_s, g_dtype=wf, setup_chunk=setup_chunk))
    del hm_s
    if R > 1:
        t_exp, _ = wall(lambda: expand_strided_samples(
            *Ts, M=M, stride=R, g_dtype=gdt, setup_chunk=setup_chunk))
    else:
        t_exp = 0.0
    del Ts
    t_hf, _ = wall(lambda: _schur_t_stack(
        fd_stencil.extract_hf_stencil(A, b)))

    pk = _peaks(dev, peaks)
    model_tflop = Ms * b * (16.0 * n ** 3 + 8.0 * n ** 2) / 1e12
    eff_tflops = model_tflop / max(t_fac, 1e-9)
    gj_tflop = Ms * b * (8.0 * n ** 3 + 8.0 * n ** 2) / 1e12
    gj_tflops = gj_tflop / max(t_fac, 1e-9)
    item = torch.empty((), dtype=gdt).element_size()
    wf_item = torch.empty((), dtype=wf).element_size()
    exp_gb = 2 * (Ms * wf_item + M * item) * n * n / 1e9
    exp_rate = exp_gb / t_exp if t_exp else None
    return {
        "kernel": "setup_phases", "n": n, "b": b,
        "factor_stride": R, "samples": int(Ms), "g_dtype": g_dtype,
        "assembly_s": t_asm,
        "factor_samples_s": t_fac,
        "expand_s": t_exp,
        "hf_s": t_hf,
        "total_warm_s": t_asm + t_fac + t_exp + t_hf,
        "factor_model_tflop": model_tflop,
        "factor_effective_tflops": eff_tflops,
        "measured_matmul_tflops": pk["matmul_tflops"],
        "published_tflops": PUBLISHED_F32_FLOPS / 1e12,
        "roofline_fraction": eff_tflops / (PUBLISHED_F32_FLOPS / 1e12),
        "roofline_fraction_measured": eff_tflops / pk["matmul_tflops"],
        "factor_gj_tflop": gj_tflop,
        "factor_gj_tflops": gj_tflops,
        "roofline_fraction_gj": gj_tflops / (PUBLISHED_F32_FLOPS / 1e12),
        "roofline_fraction_gj_measured": gj_tflops / pk["matmul_tflops"],
        "expand_gb": exp_gb,
        "expand_fraction": (exp_rate / (PUBLISHED_BYTES_PER_S / 1e9)
                            if exp_rate else None),
        "expand_fraction_measured": (exp_rate / pk["stream_gb_s"]
                                     if exp_rate else None),
        "traffic_model": "factor fraction = Schur-recursion flop model "
                         "(Ms*b inverses at 16n^3 real flops, the JAX "
                         "count) / float32 peak; _gj: at 8n^3, the "
                         "inverse's own work; expand fraction = (read samples + write "
                         "dense G) / memory peak; published peaks, "
                         "_measured: the measured matmul and streaming "
                         "rates",
    }


@torch.no_grad()
def measure_sweep(n: int = 1023, b: int = 12, g_dtype: str = "working", *,
                  peaks: dict | None = None, device="cuda") -> dict:
    """Preconditioner-apply rate against the G stream's roofline.

    One apply streams the (M, n, ld) real planes of the corner-inverse
    stack twice (forward sweep, fused diagonal and backward sweep; the
    sweep kernel on the card), its dominant traffic; the rows it writes are
    O(M n), about 1/n of it.  The stack is factored at the auto stride and
    expanded (dense G).  `s_per_apply` is a loop of eager applies, the
    host's launches included (the block-Thomas solves are many small
    host-launched ops).  Fractions against the published read rate and the
    measured one."""
    from ..driver import _factor_stage, auto_factor_stride
    from ..precond.sweeping import apply_preconditioner

    dev = resolve_device(device)
    A, hm, f = _problem(n, b, "as-shipped", dev)
    P = _factor_stage(A, hm, b=b, hf_full_coupling=True, d2_replace=True,
                      setup_chunk=128, g_dtype=g_dtype,
                      factor_stride=auto_factor_stride(n, "c1_f1", dev),
                      device=dev)
    del hm
    u = f.reshape(n, n)
    dt = _seconds_per_call(lambda: apply_preconditioner(P, u), 5, dev)
    M, _, ld = P.G_re.shape
    g_gb = 2 * 2 * M * n * ld * P.G_re.element_size() / 1e9
    bw = _peaks(dev, peaks)["read_gb_s"]
    return {
        "kernel": "sweep_apply",
        "n": n,
        "subgrids": M,
        "s_per_apply": dt,
        "g_traffic_gb_per_apply": g_gb,
        "effective_gb_per_s": g_gb / dt,
        "measured_read_bw_gb_s": bw,
        "published_gb_s": PUBLISHED_BYTES_PER_S / 1e9,
        "traffic_model": "G stream 2 passes, pure read, / published read "
                         "rate; _measured: / the measured read rate",
        "roofline_fraction": (g_gb / dt) / (PUBLISHED_BYTES_PER_S / 1e9),
        "roofline_fraction_measured": (g_gb / dt) / bw,
    }
