"""Capacity planner: device memory budget and device count for a target grid.

Ported from the JAX package's `bench/plan.py` (`plan`, `plan9`,
`plan_distributed`, `main`), with every byte count re-derived for the
port's own layout on the card:

  * the corner-inverse stack G is two real planes of (panels, n, ld) at the
    storage type, row pitch ld = `ops.kernels.sweep.g_ld(n)` (n rounded up
    to 8); the panels are n - b (dense), (n-b-1)//R + 2 (sample-compressed
    at stride R) or the samples of a strided setup;
  * H_F's block-Thomas stack TF is complex64 (b, n, n) on both stencils
    (the 9-point one rounded to the G type but held widened,
    `precond.sweeping9`);
  * the setup's batched inverse holds `SETUP_BYTES_PER_WORD` bytes per
    complex word of its chunk (`precond.sweeping._clamped_chunk` subgrids,
    at least 16, `SETUP_WORKSPACE_WORDS // n^2`);
  * a strided dense setup holds its float32 sample planes while it
    lerp-expands them chunk by chunk (`EXPAND_WORKSPACE_WORDS`), with
    `EXPAND_TEMPORARIES` float32 chunks live at once;
  * the Krylov basis is (restart + 2) vectors of n^2 complex64 words a
    right-hand side.

The peak is the largest of the phases one solve passes through: the
corner-inverse setup, the lerp expansion, H_F's factorization (its stack is
built as a list and stacked, and the 9-point one rounded to the G type, so
two to three copies are live), and the solve.  It is a prediction: the
constants were fitted to nothing but the n <= 1023 peaks that
`chip_smoke.py` measured, and the card's own measurements of the n = 2047
paths stand beside it (`chip_smoke.py`, `plan_check`).

    python -m helmholtz_tpu_torch plan --n 2047 --batch 4
"""
from __future__ import annotations

import argparse
import json
import sys

import torch

from .._device import resolve_device
from ..ops.kernels.sweep import g_ld
from ..precond.sweeping import (DEFAULT_SETUP_CHUNK, EXPAND_WORKSPACE_WORDS,
                                _clamped_chunk, band_sample_window)

#: device bytes the layer-Schur recursion holds per complex word of its
#: batch (the blocked Gauss-Jordan's padded work matrix, its panel row and
#: column, the Schur matrix and the previous layer's inverse), measured by
#: `scripts/measure_setup_chunk.py` on an H100 80GB (700 W) at n = 1023
#: for every chunk from 4 to 300 (`precond.sweeping.SETUP_WORKSPACE_WORDS`)
SETUP_BYTES_PER_WORD = 30.6

#: float32 chunks live at once in one step of the lerp expansion
#: (`precond.sweeping.expand_strided_samples`): (1 - w) T[lo], T[hi] and
#: w T[hi], then the sum
EXPAND_TEMPORARIES = 3

_G_ITEM = {"f32": 4, "working": 4, "bf16": 2}
_C64 = 8
_F32 = 4


def _hbm_gb(hbm_gb: float, device) -> float:
    """The card's memory in GB when a device is named, else `hbm_gb`."""
    if device is None:
        return hbm_gb
    dev = resolve_device(device)
    if dev.type != "cuda":
        return hbm_gb
    return torch.cuda.get_device_properties(dev).total_memory / 1e9


def _samples(M: int, R: int) -> int:
    """Subgrids a stride-R setup factors (`sample_positions`)."""
    return (M - 1) // R + 2 if R > 1 and M > R else M


def _phases(n: int, b: int, *, fields: int, batch: int, restart: int,
            g_item: int, panels: int, factored: int, strided_dense: bool,
            family_subgrids: int, setup_chunk: int, tf_copies: int) -> dict:
    """Bytes of each phase of one solve in the port's layout.  `panels`:
    G panels stored; `factored`: subgrids the setup inverts; `family_subgrids`:
    subgrids of the assembled family live during the setup (all of them for
    the 5-point path, one chunk for the sampled 9-point setup);
    `tf_copies`: copies of H_F's stack live while it is built."""
    N = n * n
    ld = g_ld(n)
    M = n - b
    g = 2 * panels * n * ld * g_item
    samples = 2 * factored * n * ld * _F32 if strided_dense else 0
    tf = b * N * _C64
    operator = fields * N * _C64 + 2 * N * _C64   # A, forcing, velocity
    family = fields * family_subgrids * b * n * _C64
    gathered = (5 * factored * b * n * _C64
                if fields == 5 and factored < M else 0)
    chunk = min(_clamped_chunk(setup_chunk, n), factored)
    setup_ws = SETUP_BYTES_PER_WORD * chunk * N
    wchunk = min(M, max(4, min(setup_chunk, EXPAND_WORKSPACE_WORDS
                               // (n * ld))))
    expand_ws = EXPAND_TEMPORARIES * wchunk * n * ld * _F32
    sources = batch * N * _C64
    krylov = (restart + 2) * N * _C64 * batch
    base = operator + sources
    # the 5-point family lives until the whole factorization is done; the
    # 9-point sampled setup builds it one chunk at a time and drops it
    # before the expansion and H_F
    held = family + gathered
    after = held if family_subgrids == M else 0
    setup = base + held + (samples if strided_dense else g) + setup_ws
    expand = (base + after + samples + g + expand_ws) if strided_dense else 0
    hf = base + after + g + tf_copies * tf + SETUP_BYTES_PER_WORD * N
    solve = base + g + tf + krylov
    return dict(g=g, samples=samples, tf=tf, operator=operator,
                family=family, setup_ws=setup_ws, expand_ws=expand_ws,
                krylov=krylov, setup=setup, expand=expand, hf=hf,
                solve=solve, peak=max(setup, expand, hf, solve))


def _gb(x: float) -> float:
    return round(x / 1e9, 3)


def plan(n: int, b: int = 12, batch: int = 1, restart: int = 20,
         hbm_gb: float = 80.0, setup_chunk: int = DEFAULT_SETUP_CHUNK,
         g_dtype: str = "f32", g_compress_stride: int = 0,
         factor_stride: int = 1, device=None) -> dict:
    """Memory plan of the 5-point path (`run_solver` / `run_multisolve`
    with `batch` sources) at grid size n on one card.

    `g_compress_stride` > 0 budgets the sample-compressed factor stack
    (`setup_preconditioner(g_compress=True)`): G holds (M-1)//R + 2 sampled
    corner inverses instead of M.  `factor_stride` > 1 without compression
    budgets the strided dense setup: the float32 samples are factored, then
    lerp-expanded into the dense stack while both are live, the peak of
    that path.  `precond="recompute"` needs no plan: its at-rest state is
    O(n^2).  `device="cuda"` takes the card's memory from
    `torch.cuda.get_device_properties` in place of `hbm_gb`."""
    hbm_gb = _hbm_gb(hbm_gb, device)
    M = n - b
    R = g_compress_stride or factor_stride
    compressed = bool(g_compress_stride) and M > g_compress_stride
    factored = _samples(M, R)
    panels = factored if compressed else M
    ph = _phases(n, b, fields=5, batch=batch, restart=restart,
                 g_item=_G_ITEM[g_dtype], panels=panels, factored=factored,
                 strided_dense=(not compressed and factored < M),
                 family_subgrids=M, setup_chunk=setup_chunk, tf_copies=2)
    hbm = hbm_gb * 1e9
    fits = ph["peak"] < 0.92 * hbm
    # row-sharded: G, A, the family and the vectors split across D devices;
    # TF and the setup workspace are not
    sharded = lambda D: (ph["g"] + ph["operator"] + ph["family"]
                         + ph["krylov"]) / D + ph["tf"] + ph["setup_ws"]
    min_dev = 1
    while sharded(min_dev) >= 0.92 * hbm and min_dev < 4096:
        min_dev *= 2
    return {
        "n": n, "b": b, "batch": batch, "ld": g_ld(n), "g_dtype": g_dtype,
        "g_compress_stride": g_compress_stride,
        "factor_stride": max(1, factor_stride),
        "g_blocks_stored": panels,
        "g_stack_gb": _gb(ph["g"]),
        "g_samples_gb": _gb(ph["samples"]),
        "tf_stack_gb": _gb(ph["tf"]),
        "operator_gb": _gb(5 * n * n * _C64 + ph["family"]),
        "krylov_gb": _gb(ph["krylov"]),
        "setup_workspace_gb": _gb(ph["setup_ws"]),
        "expand_workspace_gb": _gb(ph["expand_ws"]
                                   if ph["samples"] else 0),
        "phase_gb": {k: _gb(ph[k]) for k in ("setup", "expand", "hf",
                                              "solve")},
        "peak_gb": _gb(ph["peak"]),
        "hbm_gb": hbm_gb,
        "fits_single_chip": bool(fits),
        "min_devices_row_sharded": int(min_dev),
        "per_device_gb_at_min": _gb(sharded(min_dev)),
        "note": ("G planes at pitch g_ld(n); TF complex64; on the "
                 "distributed path G shards with the grid rows and the "
                 "F-band factors replicate (plan_distributed)"),
    }


def plan9(n: int, b: int | None = None, batch: int = 1, restart: int = 20,
          hbm_gb: float = 80.0, g_dtype: str = "bf16",
          factor_stride: int = 8, g_compress: bool = True,
          setup_chunk: int = DEFAULT_SETUP_CHUNK, device=None) -> dict:
    """Capacity plan for the 9-POINT path: b defaults to the enforced
    ~n/14 recipe (at least 12); the sampled nine-field family is a
    TRANSIENT chunk (`setup_preconditioner9_assembling` assembles it
    inside the factor loop); the compressed sample panels are the at-rest
    G; TF is complex64 (b, n, n), its values rounded to the G type.  While
    H_F is factored its stack is built as a list and stacked, then rounded
    through two float32 planes into a new stack: about three stacks live,
    the peak of the compressed path at large b.

    The JAX planner's `hostloop_envelope` key is dropped: the host-driven
    loop and the host-chunked setup it flags are not ported."""
    if b is None:
        b = max(12, -(-n // 14))
    hbm_gb = _hbm_gb(hbm_gb, device)
    M = n - b
    R = max(1, factor_stride)
    factored = _samples(M, R)
    compressed = bool(g_compress) and factored < M
    panels = factored if compressed else M
    sampled = factored < M
    chunk = min(_clamped_chunk(setup_chunk, n), factored)
    ph = _phases(n, b, fields=9, batch=batch, restart=restart,
                 g_item=_G_ITEM[g_dtype], panels=panels, factored=factored,
                 strided_dense=(sampled and not compressed),
                 family_subgrids=chunk if sampled else M,
                 setup_chunk=setup_chunk,
                 tf_copies=2 if _G_ITEM[g_dtype] == 4 else 3)
    hbm = hbm_gb * 1e9
    return {
        "n": n, "b": b, "batch": batch, "ld": g_ld(n),
        "g_dtype": g_dtype, "factor_stride": R,
        "g_compress": bool(g_compress), "g_panels_stored": int(panels),
        "g_stack_gb": _gb(ph["g"]),
        "g_samples_gb": _gb(ph["samples"]),
        "tf_stack_gb": _gb(ph["tf"]),
        "operator_gb": _gb(9 * n * n * _C64),
        "krylov_gb": _gb(ph["krylov"]),
        "setup_transient_gb": _gb(ph["family"] + ph["setup_ws"]),
        "phase_gb": {k: _gb(ph[k]) for k in ("setup", "expand", "hf",
                                              "solve")},
        "peak_gb": _gb(ph["peak"]),
        "hbm_gb": hbm_gb,
        "fits_single_chip": bool(ph["peak"] < 0.92 * hbm),
        "note": ("b defaults to the enforced ~n/14 recipe "
                 "(driver.min_pml_width9, at least 12); TF complex64 "
                 "rounded to g_dtype; the sampled family is one chunk"),
    }


def plan_distributed(n: int, b: int = 12, devices: int = 8,
                     factor_stride: int = 8, g_dtype: str = "bf16",
                     g_compress: bool = True,
                     hbm_gb: float = 80.0, *, batch: int = 1,
                     restart: int = 20, stencil: str = "5pt",
                     setup_chunk: int = DEFAULT_SETUP_CHUNK) -> dict:
    """Per-device budget of the distributed setup and solve
    (`dist.factor.distributed_setup(9)`, `dist.solve`): how much G each
    rank stores and how many subgrid factorizations it pays, against the
    dense stride-1 per-band setup, through the sample-window geometry
    (globally anchored samples, one-sample band overlap) of
    `dist.partition.band_sample_windows`; and each rank's peak device
    memory over the phases it passes through, in the port's layout:

      setup   the band's operator rows, the full velocity and forcing
              grids, the band's subgrid family (5-point: every subgrid the
              rank factors; 9-point: one chunk, assembled inside the factor
              loop), the factored planes (float32 samples of a strided
              dense setup) and the batched inverse's workspace; a dense
              stride-1 band adds its row-aligned copy (rank 0's F panels);
      expand  a strided dense band's samples and its dense planes while
              the lerp expands one into the other;
      hf      H_F's stack being built (two or three copies) beside G;
      solve   G, H_F's stack, the band's Krylov basis of `batch` vectors
              and the full and banded forcings.

    Like `plan`, a prediction; `chip_smoke.py` (`plan_check`) holds each
    rank's measured peak to it."""
    from ..dist.partition import band_sample_windows

    M = n - b
    R = max(1, factor_stride)
    # the distributed setup needs devices | n; when the target n (2047, say)
    # is not divisible, budget the padded-rows band ceil(n / D)
    n_loc = -(-n // devices)
    g_item = _G_ITEM[g_dtype]
    ld = g_ld(n)
    nine = stencil == "9pt"
    ms_loc = (band_sample_windows(M, R, b, n_loc, devices)[1] if R > 1
              else n_loc)
    subgrids_per_dev = ms_loc if R > 1 else n_loc
    compressed = R > 1 and g_compress
    panels_per_dev = ms_loc if compressed else n_loc
    per_dev_g = 2 * panels_per_dev * n * ld * g_item
    dense_per_dev_g = 2 * n_loc * n * ld * g_item

    N, Nl = n * n, n_loc * n
    fields = 9 if nine else 5
    strided_dense = R > 1 and not compressed
    samples = 2 * subgrids_per_dev * n * ld * _F32 if strided_dense else 0
    tf = b * N * _C64
    operator = fields * Nl * _C64 + 2 * N * _C64
    chunk = min(_clamped_chunk(setup_chunk, n), subgrids_per_dev)
    family = fields * (chunk if nine else subgrids_per_dev) * b * n * _C64
    setup_ws = SETUP_BYTES_PER_WORD * chunk * N
    wchunk = min(n_loc, max(4, min(setup_chunk, EXPAND_WORKSPACE_WORDS
                                   // (n * ld))))
    expand_ws = EXPAND_TEMPORARIES * wchunk * n * ld * _F32
    sources = batch * (N + Nl) * _C64
    krylov = (restart + 2) * Nl * _C64 * batch
    row_copy = per_dev_g if R == 1 else 0
    setup = (operator + family + (samples if strided_dense else per_dev_g)
             + setup_ws + row_copy)
    expand = (operator + samples + per_dev_g + expand_ws
              if strided_dense else 0)
    tf_copies = 3 if nine and g_item != 4 else 2
    hf = operator + per_dev_g + tf_copies * tf + SETUP_BYTES_PER_WORD * N
    solve = operator + per_dev_g + tf + krylov + sources
    phases = dict(setup=setup, expand=expand, hf=hf, solve=solve)
    return {
        "n": n, "b": b, "devices": devices, "factor_stride": R,
        "g_dtype": g_dtype, "g_compress": bool(g_compress),
        "stencil": stencil, "batch": batch,
        "rows_per_device": n_loc,
        "subgrids_factored_per_device": subgrids_per_dev,
        "setup_flop_fraction_vs_dense": round(subgrids_per_dev / n_loc, 4),
        "g_panels_per_device": panels_per_dev,
        "per_device_g_gb": round(per_dev_g / 1e9, 3),
        "per_device_g_gb_dense": round(dense_per_dev_g / 1e9, 3),
        "tf_stack_gb": _gb(tf),
        "phase_gb": {k: _gb(v) for k, v in phases.items()},
        "peak_gb": _gb(max(phases.values())),
        "hbm_gb": hbm_gb,
        "fits_per_device": bool(max(phases.values()) < 0.92 * hbm_gb * 1e9),
    }


def main(argv=None):
    ap = argparse.ArgumentParser(prog="helmholtz_tpu_torch plan")
    ap.add_argument("--n", type=int, required=True)
    ap.add_argument("--b", type=int, default=12)
    ap.add_argument("--batch", type=int, default=1)
    ap.add_argument("--restart", type=int, default=20)
    ap.add_argument("--hbm-gb", type=float, default=80.0)
    ap.add_argument("--g-dtype", default="f32",
                    choices=["f32", "bf16", "working"])
    ap.add_argument("--g-compress-stride", type=int, default=0)
    ap.add_argument("--devices", type=int, default=0,
                    help="report the distributed per-device budget too")
    ap.add_argument("--factor-stride", type=int, default=1)
    ap.add_argument("--stencil", default="5pt", choices=["5pt", "9pt"])
    ap.add_argument("--device", default=None, choices=["cuda", "cpu"],
                    help="cuda: take the card's memory in place of "
                         "--hbm-gb (raises without a card)")
    args = ap.parse_args(argv)
    if args.stencil == "9pt":
        out = plan9(args.n, None if args.b == 12 else args.b, args.batch,
                    args.restart, args.hbm_gb, g_dtype=args.g_dtype,
                    factor_stride=(args.factor_stride
                                   if args.factor_stride > 1 else 8),
                    device=args.device)
        print(json.dumps(out, indent=1))
        return 0
    out = plan(args.n, args.b, args.batch, args.restart, args.hbm_gb,
               g_dtype=args.g_dtype,
               g_compress_stride=args.g_compress_stride,
               factor_stride=args.factor_stride, device=args.device)
    if args.devices:
        out["distributed"] = plan_distributed(
            args.n, args.b, args.devices, args.factor_stride,
            g_dtype=args.g_dtype,
            g_compress=args.g_compress_stride > 0 or args.factor_stride > 1,
            hbm_gb=args.hbm_gb)
    print(json.dumps(out, indent=1))
    return 0


if __name__ == "__main__":
    sys.exit(main())
