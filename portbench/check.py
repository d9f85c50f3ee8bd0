"""The check that decides `correct`.

The window's requests are judged one by one: every right-hand side must
converge (GMRES's own test, on the preconditioned residual), and for a
sample of the requests, drawn from the seed, the plain reference
(`reference.helmholtz`) re-derives the operator and each source's forcing
in complex128 from the numbers the harness handed the program, and reads
the true relative residual ||A u - f|| / ||f|| of every solution of the
request.  The worst of them is compared with the cell's limit
(`portbench/limits/<cell>.json`), which PERF.md derives from sound runs and
from the control (`control.py`: the program with its operator product fed
TF32).  The window must also have launched the sweep kernel only in the G
layout the configuration states.
"""
from __future__ import annotations

import json
import pathlib

import numpy as np

from reference import helmholtz as ref

DIR = pathlib.Path(__file__).resolve().parent / "limits"


def load_limits(cell: str) -> dict:
    return json.loads((DIR / f"{cell}.json").read_text())


def residuals(cfg: dict, req, X: np.ndarray) -> list:
    """The reference's true residual of each solution (rows of X) of one
    request."""
    return ref.true_residuals(
        X, n=int(cfg["n"]), b=int(cfg["b"]), const=float(cfg["const"]),
        alpha=float(cfg["alpha"]), wave_num=req.wave_num,
        medium=cfg["medium"], xs=req.xs, ys=req.ys, source=cfg["forcing"])


def other_mode_launches(cfg: dict, launches: dict) -> int:
    """Sweep-kernel launches of the window whose G layout is not the one
    the configuration states (`k2_mode`: dense, shared or lerp)."""
    return sum(c for key, c in launches.get("k2", {}).items()
               if key.split(".")[2] != cfg["k2_mode"])


def judge(cfg: dict, kept: list, unconverged: int, limits: dict,
          launches: dict):
    """(numbers, rejected, checked): each number compared with its limit,
    how many checked right-hand sides read above the residual limit, and
    how many were checked (none checked reads as NaN, which fails).  `kept` is
    a list of (request, solutions as a (K, n*n) host array); `launches` the
    window's launch counters."""
    limit = float(limits["max_true_residual"])
    r = [v for req, X in kept for v in residuals(cfg, req, X)]
    rejected = sum(1 for v in r if not v <= limit)
    numbers = {
        "worst_true_residual": {"value": max(r, default=float("nan")),
                                "limit": limit},
        "unconverged_rhs": {"value": int(unconverged), "limit": 0},
        "k2_other_mode_launches": {
            "value": other_mode_launches(cfg, launches), "limit": 0},
    }
    return numbers, rejected, len(r)


def passes(numbers: dict) -> bool:
    w = numbers["worst_true_residual"]
    return (w["value"] <= w["limit"]
            and numbers["unconverged_rhs"]["value"] <= 0
            and numbers["k2_other_mode_launches"]["value"] <= 0)
