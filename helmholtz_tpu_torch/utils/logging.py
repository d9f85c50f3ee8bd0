"""Structured metrics logging and the reference's iteration callback.

JSON lines of run metrics per solve (iteration counts, timings, residuals)
and a `GmresCounter` with the reference's callback semantics, for host-side
post-processing of residual histories.  Ported from the JAX package's
`utils/logging.py`.
"""
from __future__ import annotations

import json
import sys
import time

import numpy as np


class GmresCounter:
    """Host-side analog of the reference's `gmres_counter`: feed it a
    residual history (KrylovResult.history) to replay per-iteration
    callbacks, or call it incrementally."""

    def __init__(self, disp: bool = True):
        self._disp = disp
        self.niter = 0
        self.residuals: list[float] = []

    def __call__(self, rk=None):
        self.niter += 1
        if rk is not None:
            self.residuals.append(float(rk))
        if self._disp:
            print(f"iter {self.niter:3d}\trk = {rk}")

    def replay(self, history) -> "GmresCounter":
        for rk in np.asarray(history):
            if not np.isnan(rk):
                self(rk)
        return self


def log_metrics(report, path: str | None = None, extra: dict | None = None):
    """Append one JSON line of run metrics to `path` (or stderr)."""
    rec = {"ts": time.time(), **report.metrics(), **(extra or {})}
    line = json.dumps(rec)
    if path:
        with open(path, "a") as fh:
            fh.write(line + "\n")
    else:
        print(line, file=sys.stderr)
    return rec
