"""The device's measured peaks: streaming and read-only memory rates and
the float32 matrix-product rate.  The kernels' bounds are stated against
the card's published peaks; the bound at these, stated beside it, says how
much of the gap to a bound the card's reachable rates already explain.

Ported from the JAX package's `bench/roofline.py`: `measure_streaming_bw`,
`measure_read_bw` and `measure_matmul_tflops`.  Each runs one eager torch
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

import torch

from .._device import resolve_device


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
