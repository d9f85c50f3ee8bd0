"""One run of one cell: set-up, the measured window, the check, the result.

`run_cell` takes the cell's configuration, traffic mix and limits as data,
so the tests drive it on the CPU at a tiny size with the program's timed
path broken underneath; `run.py` is the command that finds those by name
and refuses to run without a card.
"""
from __future__ import annotations

import contextlib
import dataclasses
import importlib.util
import pathlib
import sys
import time

import numpy as np
import torch

import check
import devtrace as tracing
import entry
import traffic
from helmholtz_tpu_torch.ops.kernels import (build, gj_inverse, spmv_stencil,
                                             sweep)
from spans import Spans

METRICS_DIR = pathlib.Path(__file__).resolve().parent / "metrics"
#: top-level module names that may not be loaded in the process
FORBIDDEN = ("jax", "jaxlib", "flax", "helmholtz_tpu")


@dataclasses.dataclass
class RequestRecord:
    index: int
    k: int
    iterations: np.ndarray
    converged: np.ndarray


@dataclasses.dataclass
class RunData:
    """What the metric readers read."""
    config: dict
    mix: dict
    setup_s: float
    window_s: float
    attempted: int
    failed: int
    peak_bytes: int
    requests: list
    spans: list
    applies: list
    trace: object
    launches: dict

    @property
    def rhs_ok(self) -> int:
        return self.attempted - self.failed


def read_metric(name: str, run: RunData):
    """The metric's own reader, `metrics/<name>.py`'s `read(run)`; None
    where it finds nothing to read."""
    spec = importlib.util.spec_from_file_location(
        "portbench_metric_" + name.replace(".", "_").replace("-", "_"),
        METRICS_DIR / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read(run)


def forbidden_modules() -> list:
    return sorted({m.split(".", 1)[0] for m in sys.modules}
                  & set(FORBIDDEN))


def _reset_launch_counts():
    spmv_stencil.reset_counts()
    sweep.reset_counts()
    gj_inverse.reset_counts()


def _launch_counts() -> dict:
    k2 = {}
    for (mode, width, lerp, tri, shared), c in sorted(
            sweep.launches_by_variant.items()):
        g = "shared" if shared else "lerp" if lerp else "dense"
        key = f"{mode}.R{width}.{g}" + (".tri" if tri else "")
        k2[key] = k2.get(key, 0) + c
    return {"k1": spmv_stencil.launches, "k2": k2, "k3": gj_inverse.launches}


def run_cell(cell: dict, cfg: dict, mix: dict, limits: dict, *, seed: int,
             seconds: float, trace: bool, metric_defs: list, device,
             t_start: float, gather=entry.gather,
             min_requests: int = 0) -> dict:
    """Warm up, measure for `seconds` (and at least `min_requests`
    requests), check, and return the result line's object.  `metric_defs`
    are the BENCHMARK.json entries to report."""
    dev = torch.device(device)
    cuda = dev.type == "cuda"
    sync = (lambda: torch.cuda.synchronize(dev)) if cuda else (lambda: None)
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])
    solver = dict(rtol=float(mix["rtol"]), restart=int(mix["restart"]),
                  maxiter=int(mix["maxiter"]))

    def call(req, spans=None, applies=None):
        return gather(cfg, req.wave_num, req.xs, req.ys, device=dev,
                      spans=spans, applies=applies, **solver)

    if cuda:
        build.library()
    # a checkout's first run builds the library inside set-up; the time is
    # also given apart, so that such a run can be told from the others
    build_s = build.last_build_seconds or 0.0
    warm = call(traffic.warmup_request(mix, seed))
    del warm
    sync()
    setup_s = time.perf_counter() - t_start

    spans = Spans(sync) if trace else None
    applies = [] if trace else None
    keep_rng = traffic.check_rng(seed)
    n_keep = int(mix["check_requests"])
    kept: list = []
    records: list = []
    if cuda:
        torch.cuda.reset_peak_memory_stats(dev)
    _reset_launch_counts()
    window_s = 0.0
    pauses: list = []
    with tracing.profiler() if trace else contextlib.nullcontext() as prof:
        if trace:
            mark_ns = tracing.mark(sync)
        w0 = time.perf_counter_ns()
        i = 0
        while window_s < seconds or i < min_requests:
            req = traffic.request(mix, seed, i)
            t0 = time.perf_counter()
            if spans is not None:
                spans.request = i
                with spans.span("request"):
                    out = call(req, spans, applies)
            else:
                out = call(req)
            window_s += time.perf_counter() - t0
            records.append(RequestRecord(i, len(req.xs), out.iterations,
                                         out.converged))
            # the check's copy is made with the window's clock stopped
            slot = (len(kept) if len(kept) < n_keep
                    else int(keep_rng.integers(i + 1)))
            if slot < n_keep:
                p0 = time.perf_counter_ns()
                X = out.x.cpu().numpy()
                if slot < len(kept):
                    kept[slot] = (req, X)
                else:
                    kept.append((req, X))
                pauses.append((p0, time.perf_counter_ns()))
            del out
            i += 1
        w1 = time.perf_counter_ns()
        peak = int(torch.cuda.max_memory_allocated(dev)) if cuda else 0
        launches = _launch_counts()
        sync()
    tr = tracing.collect(prof, mark_ns, (w0, w1), pauses) if trace else None
    if cuda:
        torch.cuda.empty_cache()

    attempted = sum(r.k for r in records)
    unconverged = int(sum(int((~np.asarray(r.converged, bool)).sum())
                          for r in records))
    numbers, rejected, checked = check.judge(cfg, kept, unconverged, limits,
                                             launches)
    correct = check.passes(numbers)
    run = RunData(config=cfg, mix=mix, setup_s=setup_s, window_s=window_s,
                  attempted=attempted, failed=unconverged + rejected,
                  peak_bytes=peak, requests=records,
                  spans=spans.records if spans is not None else [],
                  applies=applies or [], trace=tr, launches=launches)
    metrics = {}
    for m in metric_defs:
        value = read_metric(m["name"], run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device_info = {
        "platform": "gpu" if cuda else "cpu",
        "kind": torch.cuda.get_device_name(dev) if cuda else "cpu",
        "count": int(cell.get("chips", 1)),
        "memory_peak_bytes": peak,
    }
    result = {"correct": correct, "attempted": attempted,
              "failed": run.failed, "metrics": metrics,
              "device": device_info}
    if tr is not None:
        device_info["busy_s"] = tr.busy_s
        device_info["window_s"] = tr.window_s
        result["breakdown"] = tracing.breakdown(tr, run.spans)
    result["requests"] = len(records)
    result["setup_build_s"] = build_s
    result["iters_per_rhs"] = read_metric("krylov.iters_per_rhs", run)
    result["launches"] = launches
    result["checked_rhs"] = checked
    result["check"] = numbers
    return result
