"""Checkpoint / resume for long Krylov runs, ported from the JAX package's
`solve/resumable.py` (the same file formats).

  * `resumable_gmres` checkpoints the in-flight solver state (x, iteration
    count, residual history) every K restart cycles.  GMRES(m) carries only
    x between cycles and recomputes the preconditioned residual at each
    cycle boundary, the same computation an `x0` resume performs, so a
    killed-and-resumed run retraces the uninterrupted iteration sequence
    (on one device, to the bit).
  * multi-frequency sweeps: `run_multisolve` callers checkpoint per
    completed frequency with `SweepCheckpoint`, skipping finished
    frequencies on restart.
"""
from __future__ import annotations

import json
import os
from typing import Callable, Optional

import numpy as np
import torch

from .gmres import KrylovResult, gmres


def save_krylov_state(path: str, x, iterations: int, history,
                      meta: dict | None = None) -> str:
    """Persist in-flight solver state as split-real numpy arrays."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    np.savez_compressed(
        path, x_re=np.real(x), x_im=np.imag(x),
        iterations=np.asarray(iterations), history=np.asarray(history),
        _meta=np.frombuffer(json.dumps(meta or {}).encode(), np.uint8))
    return path


def load_krylov_state(path: str):
    """(x as complex numpy, iterations, history, meta)."""
    z = np.load(path)
    meta = json.loads(bytes(z["_meta"]).decode())
    x = z["x_re"] + 1j * z["x_im"]
    return x, int(z["iterations"]), z["history"], meta


def resumable_gmres(matvec: Callable, b: torch.Tensor, *,
                    M: Optional[Callable] = None,
                    checkpoint_path: str,
                    restart: int = 20, rtol: float = 1e-3,
                    maxiter: int = 200, cycles_per_checkpoint: int = 1,
                    resume: bool = True,
                    meta: dict | None = None,
                    device="cuda") -> KrylovResult:
    """Restarted GMRES that checkpoints at restart-cycle boundaries.

    Runs `cycles_per_checkpoint` restart cycles per segment (one `gmres`
    call with x0 = the previous segment's x), saves (x, total iterations,
    history) after each, and resumes from `checkpoint_path` if it exists.
    The result is that of one uninterrupted `gmres` call with the same
    parameters: checkpoints coincide with restart boundaries, and the only
    state GMRES(m) carries across a boundary is x.  The history holds the
    iterations performed, without nan padding.
    """
    x0 = None
    iters_done = 0
    hist_parts = []
    if resume and os.path.exists(checkpoint_path):
        x_np, iters_done, hist, _ = load_krylov_state(checkpoint_path)
        x0 = torch.from_numpy(x_np).to(dtype=b.dtype, device=b.device)
        hist_parts.append(hist)

    seg_iters = restart * cycles_per_checkpoint
    res = None
    while iters_done < maxiter:
        budget = min(seg_iters, maxiter - iters_done)
        res = gmres(matvec, b, M=M, x0=x0, restart=restart, rtol=rtol,
                    maxiter=budget, device=device)
        seg_hist = res.history[~np.isnan(res.history)][:res.iterations]
        hist_parts.append(seg_hist)
        iters_done += res.iterations
        x0 = res.x
        save_krylov_state(checkpoint_path, res.x, iters_done,
                          np.concatenate(hist_parts), meta)
        if res.converged or res.breakdown or res.iterations == 0:
            break

    history = (np.concatenate(hist_parts) if hist_parts
               else np.zeros(0, np.float64))
    return KrylovResult(
        x=x0, iterations=iters_done,
        converged=res.converged if res is not None else False,
        breakdown=res.breakdown if res is not None else False,
        residual_norm=res.residual_norm if res is not None else np.inf,
        history=history)


class SweepCheckpoint:
    """Per-frequency progress record for multi-frequency sweeps.

    Records key on the FULL solve configuration (grid, PML width, problem,
    frequency, C, tolerance, batch size, and every solver-defining option:
    stencil and its blend, preconditioner, precision and refinement, G type,
    stride and compression, anchor spacing, mesh), so a resumed sweep with
    ANY changed configuration solves again instead of replaying a record
    computed under another path.  The template comes from
    `driver.multisolve_key_config`; records of other configurations
    sharing the file are ignored by `matching`."""

    _KEY = ("n", "b", "problem", "wave_num", "const", "rtol", "n_sources",
            "fidelity", "stencil", "stencil_gamma", "precond", "precision",
            "precond_refine", "g_dtype", "factor_stride", "g_compress",
            "freq_anchor_every", "mesh_devices")

    def __init__(self, path: str):
        self.path = path
        self.records = []
        if path and os.path.exists(path):
            with open(path) as fh:
                self.records = [json.loads(line) for line in fh
                                if line.strip()]

    @classmethod
    def key_of(cls, record: dict) -> tuple:
        return tuple(record.get(k) for k in cls._KEY)

    def done_keys(self) -> set:
        return {self.key_of(r) for r in self.records}

    def matching(self, template: dict) -> list:
        """Records whose non-frequency config matches `template`."""
        fixed = [k for k in self._KEY if k not in ("wave_num", "const")]
        return [r for r in self.records
                if all(r.get(k) == template.get(k) for k in fixed)]

    def add(self, record: dict):
        self.records.append(record)
        if self.path:
            with open(self.path, "a") as fh:
                fh.write(json.dumps(record) + "\n")
