"""One of two processes that join one process group through
`helmholtz_tpu_torch.dist.multihost.initialize` (as two hosts would) and
run the distributed multisolve in place on it.

Usage: python torch_multihost_worker.py <rank> <file-store path> <n> <b>
Prints one JSON line: the topology and the records' iteration counts.
"""
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def main():
    import torch

    torch.set_num_threads(1)
    from helmholtz_tpu_torch import run_multisolve
    from helmholtz_tpu_torch.dist.multihost import (global_layer_mesh,
                                                    initialize)

    rank, store, n, b = (int(sys.argv[1]), sys.argv[2], int(sys.argv[3]),
                         int(sys.argv[4]))
    info = initialize(f"file://{store}", world_size=2, rank=rank,
                      device="cpu")
    mesh = global_layer_mesh()
    [rec] = run_multisolve(n, b, [2.0], consts=[20.0], n_sources=2,
                           mesh_devices=2, device="cpu")
    print(json.dumps({**info, "mesh": [mesh.size, mesh.rank],
                      "iterations": rec["iterations"],
                      "converged": rec["converged"],
                      "true_residuals": rec["true_residuals"]}), flush=True)


if __name__ == "__main__":
    main()
