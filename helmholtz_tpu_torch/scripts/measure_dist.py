"""One distributed multisolve beside the same call on one card: the
records, each rank's launches, and the wall times of both, with the card's
name and power limit.

    python -m helmholtz_tpu_torch.scripts.measure_dist [--ranks 4] [--n 1024]

The backend follows `dist.launch`'s rule: NCCL when every rank has a card
of its own (four cards for four ranks), gloo with the rows staged through
host memory when ranks share a card.  The default call is `chip_smoke.py`'s
`dist_multisolve` (omega/2pi = 128, C = 100, four sources, bf16 G at the
auto stride).  Times of ranks that share a card are not scaling numbers.
"""
from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from .. import run_multisolve
from .common import card


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--ranks", type=int, default=4)
    ap.add_argument("--n", type=int, default=1024)
    ap.add_argument("--b", type=int, default=12)
    ap.add_argument("--wave-num", type=float, default=128.0)
    ap.add_argument("--const", type=float, default=100.0)
    ap.add_argument("--sources", type=int, default=4)
    args = ap.parse_args(argv)
    kw = dict(consts=[args.const], n_sources=args.sources, g_dtype="bf16")
    out = {"nvidia_smi": card(), "cards": torch.cuda.device_count()}
    for label, mesh in (("dist", args.ranks), ("single", None),
                        ("dist_again", args.ranks)):
        torch.cuda.empty_cache()
        t0 = time.perf_counter()
        [rec] = run_multisolve(args.n, args.b, [args.wave_num],
                               mesh_devices=mesh, **kw)
        out[label] = {"seconds": time.perf_counter() - t0, **{
            k: rec.get(k) for k in (
                "iterations", "converged", "true_residuals", "init_time_s",
                "solve_time_s", "dist_backend", "ranks_per_card",
                "per_device_g_bytes", "rank_peak_bytes", "rank_launches")}}
        print(json.dumps({label: out[label]}), flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
