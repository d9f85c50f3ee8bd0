"""Profiling hooks: the port's counterpart of the JAX package's
`utils/profiling.py`.

  * `trace(dir)`: a `torch.profiler` trace of any region (host ops, and
    the card's kernels when there is one), exported as a Chrome trace
    (`trace.json`) into `dir`;
  * `annotate(name)`: a named range in that trace
    (`torch.profiler.record_function`), plus an NVTX range on the card;
  * `phase(name)`: the same for a pipeline phase.  The driver's assemble /
    factor / solve stages of `run_solver` and `run_multisolve` carry one
    each, as the JAX stages carry `named_scope`.

Outside a trace a range costs a few microseconds of host time a phase.
"""
from __future__ import annotations

import contextlib
import os

import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the region and write `log_dir`/trace.json on exit."""
    os.makedirs(log_dir, exist_ok=True)
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    with torch.profiler.profile(activities=acts) as prof:
        yield log_dir
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


@contextlib.contextmanager
def annotate(name: str):
    """A named range: a `record_function` in the profiler's trace and, when
    the card is in use, an NVTX range."""
    nvtx = torch.cuda.is_available() and torch.cuda.is_initialized()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


phase = annotate
