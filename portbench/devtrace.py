"""Device activity of the traced window, from `torch.profiler`.

The profiler records CUDA activity only (kernels, copies, sets, and the
runtime calls that launch them), so the host work of the harness and of the
program costs it nothing beyond CUPTI's.  The trace is exported to the
temporary directory, read once and deleted.

Clock: before the window the harness launches one marker kernel
(`torch.cuda._sleep`) right after a synchronize and notes the host time;
the marker's start in the trace fixes the offset between the trace's clock
and the harness's spans.
"""
from __future__ import annotations

import dataclasses
import json
import os
import re
import tempfile
import time

import torch

_DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
_MARKER = "spin_kernel"


@dataclasses.dataclass
class DeviceEvent:
    name: str
    t0_ns: float          # on the harness's clock (time.perf_counter_ns)
    t1_ns: float
    grid: tuple | None
    cat: str


@dataclasses.dataclass
class Trace:
    events: list          # DeviceEvent, in the window, by start
    window_ns: tuple      # (start, end) on the harness's clock
    pauses: list = dataclasses.field(default_factory=list)
    # (t0, t1) stretches of the window in which the window's clock stood
    # still (the check's copies): left out of the window and of the busy time

    @property
    def window_s(self) -> float:
        paused = sum(b - a for a, b in self.pauses)
        return (self.window_ns[1] - self.window_ns[0] - paused) / 1e9

    def busy_intervals(self) -> list:
        """The union of device activity, as disjoint (t0, t1) intervals
        clipped to the window, with the pauses cut out."""
        w0, w1 = self.window_ns
        out = []
        for e in self.events:
            a, b = max(e.t0_ns, w0), min(e.t1_ns, w1)
            if b <= a:
                continue
            if out and a <= out[-1][1]:
                out[-1][1] = max(out[-1][1], b)
            else:
                out.append([a, b])
        for p0, p1 in self.pauses:
            cut = []
            for a, b in out:
                if b <= p0 or a >= p1:
                    cut.append([a, b])
                    continue
                if a < p0:
                    cut.append([a, p0])
                if b > p1:
                    cut.append([p1, b])
            out = cut
        return out

    @property
    def busy_s(self) -> float:
        return sum(b - a for a, b in self.busy_intervals()) / 1e9

    def kernel_seconds(self, pattern: str) -> float:
        return sum(e.t1_ns - e.t0_ns for e in self.events
                   if e.cat == "kernel" and pattern in e.name) / 1e9


def profiler():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CUDA])


def mark(sync) -> int:
    """Launch the marker after a synchronize; the host time, ns."""
    sync()
    t = time.perf_counter_ns()
    torch.cuda._sleep(1000)
    sync()
    return t


def short_name(name: str) -> str:
    """A kernel's name without its return type and argument list."""
    name = re.sub(r"^void ", "", name).replace("(anonymous namespace)::", "")
    depth, out = 0, []
    for ch in name:
        if ch == "(" and depth == 0:
            break
        depth += ch == "<"
        depth -= ch == ">"
        out.append(ch)
    return "".join(out)[:160]


def collect(prof, mark_ns: int, window_ns: tuple, pauses=()) -> Trace:
    path = os.path.join(tempfile.gettempdir(),
                        f"portbench_trace_{os.getpid()}.json")
    prof.export_chrome_trace(path)
    try:
        with open(path) as fh:
            raw = json.load(fh)
    finally:
        os.remove(path)
    evs = [e for e in raw.get("traceEvents", [])
           if e.get("ph") == "X" and e.get("cat") in _DEVICE_CATS]
    marker = [e for e in evs if _MARKER in e.get("name", "")]
    evs.sort(key=lambda e: float(e["ts"]))
    if marker:
        offset = float(marker[0]["ts"]) * 1e3 - mark_ns
    elif evs:
        offset = float(evs[0]["ts"]) * 1e3 - window_ns[0]
    else:
        offset = 0.0
    out = []
    for e in evs:
        if _MARKER in e.get("name", ""):
            continue
        t0 = float(e["ts"]) * 1e3 - offset
        t1 = t0 + float(e.get("dur", 0.0)) * 1e3
        if t1 < window_ns[0] or t0 > window_ns[1]:
            continue
        grid = e.get("args", {}).get("grid")
        out.append(DeviceEvent(e.get("name", ""), t0, t1,
                               tuple(grid) if grid else None, e["cat"]))
    return Trace(out, window_ns, list(pauses))


def breakdown(trace: Trace, spans) -> dict:
    """The device operations that took most time, by kernel name, and the
    longest idle gaps, each named by the innermost harness span around its
    middle."""
    by_name: dict = {}
    for e in trace.events:
        mid = (e.t0_ns + e.t1_ns) / 2
        if any(p0 <= mid <= p1 for p0, p1 in trace.pauses):
            continue
        key = short_name(e.name) if e.cat == "kernel" else e.cat
        by_name[key] = by_name.get(key, 0.0) + (e.t1_ns - e.t0_ns) / 1e9
    ops = sorted(by_name.items(), key=lambda kv: -kv[1])[:10]
    w0, w1 = trace.window_ns
    covered = []
    for a, b in sorted(trace.busy_intervals() + [list(p) for p in
                                                  trace.pauses]):
        if covered and a <= covered[-1][1]:
            covered[-1][1] = max(covered[-1][1], b)
        else:
            covered.append([a, b])
    edges = [w0] + [x for iv in covered for x in iv] + [w1]
    gaps = [(edges[i], edges[i + 1]) for i in range(0, len(edges), 2)
            if edges[i + 1] > edges[i]]
    gaps.sort(key=lambda g: g[0] - g[1])
    named = []
    for a, b in gaps[:10]:
        mid = (a + b) / 2
        inner = [s for s in spans if s.t0_ns <= mid <= s.t1_ns]
        where = (max(inner, key=lambda s: s.path.count("/")).path
                 if inner else "between requests")
        named.append([where, (b - a) / 1e9])
    return {"device_ops": [[k, v] for k, v in ops], "idle_gaps": named}
