"""The card's published peaks and the device-time timer that the roofline
measures, `chip_smoke.py` and the measurement scripts share.

This module imports nothing but torch, so a script that times two trees of
the package (`scripts/measure_bsr.py`) loads it by path and times both with
the same timer.
"""
from __future__ import annotations

import statistics

import torch

#: the H100 SXM's published peaks (NVIDIA's data sheet, 700 W): HBM3 rate
#: and float32 operations outside the tensor cores
PUBLISHED_BYTES_PER_S = 3.35e12
PUBLISHED_F32_FLOPS = 67e12


def device_ms(fn, reps, flush=None):
    """Median device time of fn() in ms, with the host's cost of the call
    out of it: the runs are queued behind a sleep kernel long enough for
    the host to queue them all, each between its own pair of CUDA events
    (after `flush` is rewritten, where given, so the L2 cache starts cold),
    so each pair times only the device's work of one call.  Raises if the
    host could not queue them in the time of a 50 ms sleep."""
    fn()
    torch.cuda.synchronize()
    cycles = 2_000_000                  # about 1 ms at the H100's clocks
    while True:
        pairs = [(torch.cuda.Event(enable_timing=True),
                  torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
        slept = torch.cuda.Event()
        torch.cuda._sleep(cycles)
        slept.record()
        for start, end in pairs:
            if flush is not None:
                flush.zero_()
            start.record()
            fn()
            end.record()
        queued_in_time = not slept.query()
        torch.cuda.synchronize()
        if queued_in_time:
            return statistics.median(s.elapsed_time(e) for s, e in pairs)
        if cycles >= 100_000_000:
            raise RuntimeError("the host did not queue the runs within the "
                               "sleep kernel's time")
        cycles *= 4
