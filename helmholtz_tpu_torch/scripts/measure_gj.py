"""Time the Gauss-Jordan panel kernel (K3) and the blocked inverse it serves.

    python3 -m helmholtz_tpu_torch.scripts.measure_gj

Prints the card's name and power limit, then one JSON line per
measurement, twice over in turns: K3 through the package's wrapper at
(B, 64, 64) for B = 1, 146 and 1000, and the blocked inverse
`ops.dense.batched_inverse` of the last layer's Schur blocks of the
n = 1023 setup (the main path's problem, stride 7), ms per matrix at a
batch of one and of 146.  Needs one CUDA device.
"""
import json
import sys

import torch

from helmholtz_tpu_torch.ops import dense
from helmholtz_tpu_torch.ops.kernels import gj_inverse as k3
from helmholtz_tpu_torch.precond import sweeping
from helmholtz_tpu_torch.scripts.common import (card, gj_matrices, rel_err,
                                                schur_blocks, time_ms)

SHAPES = (1, 146, 1000)     # batches of (B, 64, 64)
#: the main path's problem and stride (`chip_smoke.py` FULL, LERP_STRIDE)
FULL = dict(n=1023, b=12, wave_num=128.0, const=100.0, problem="c1_f1")
STRIDE = 7


def main():
    if not torch.cuda.is_available():
        print("measure_gj needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    print(json.dumps({"card": card()}), flush=True)
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    mats = {B: gj_matrices(B, 64, gen, dev) for B in SHAPES}
    count = len(sweeping.sample_positions(FULL["n"] - FULL["b"], STRIDE))
    schur = schur_blocks(FULL, STRIDE, count)
    blocked = {1: schur[:1].contiguous(), count: schur}
    for turn in range(2):
        for B, A in mats.items():
            _, rel = rel_err(k3.gj_inverse(A),
                             k3.gauss_jordan_inverse_unpivoted(A))
            print(json.dumps({"turn": turn, "k3": "package", "batch": B,
                              "k": 64, "rel_err": rel,
                              "ms": time_ms(lambda: k3.gj_inverse(A), 10,
                                            flush)}), flush=True)
        for B, S in blocked.items():
            ms = time_ms(lambda: dense.batched_inverse(S), 5, flush)
            print(json.dumps({"turn": turn, "blocked_inverse": B,
                              "n": FULL["n"], "ms_per_matrix": ms / B}),
                  flush=True)


if __name__ == "__main__":
    main()
