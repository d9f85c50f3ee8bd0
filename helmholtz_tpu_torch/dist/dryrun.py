"""Dry run of the distributed path on tiny shapes, with its answers checked.

The JAX package's `dryrun_multichip` on the port: the same problem is
solved by the single-card pipeline and across `n_devices` ranks, and the
distributed results must match it in iteration count and solution:

  1. the distributed setup (each rank assembles and factors its band, G
     stored as bfloat16; no rank holds more than its band);
  2. a batch of two right-hand sides (f and f / 2) through the distributed
     GMRES: iterations within one of the single-card solve's, solutions
     within 5e-3 (the second one half the first's, by linearity);
  3. one right-hand side with `precision="ir-df32"` at rtol 1e-5: within
     one iteration, solution within 1e-3;
  4. the 9-point scheme's setup and solve: within one iteration, solution
     within 5e-3.

One iteration either way allows for the order of the sums and the
bfloat16 rounding, which can move a count by one.

    python -m helmholtz_tpu_torch.dist.dryrun --devices 4 [--device cpu]
"""
from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

B_PML = 3            # < n_loc, so the F band fits on rank 0
WAVE_NUM, CONST, ALPHA = 2.0, 20.0, 2.0


def _rel(a, b) -> float:
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


def _ranks(device, n: int, n_devices: int) -> dict:
    """The distributed legs on one rank; the solutions gathered."""
    from .. import driver
    from . import comm
    from .factor import distributed_setup, distributed_setup9
    from .partition import make_mesh
    from .solve import distributed_solve

    mesh = make_mesh(n_devices, device=device)
    n_loc = n // n_devices
    driver._set_full_float32()
    before = driver._launch_counts()
    A, S, f = distributed_setup(mesh, n, B_PML, WAVE_NUM, CONST, ALPHA,
                                "c1_f1", g_dtype="bf16")
    if S.G_re.dtype != torch.bfloat16 or S.G_re.shape[0] != n_loc:
        raise AssertionError(f"rank {mesh.rank}: G band {S.G_re.dtype} "
                             f"{tuple(S.G_re.shape)}, want bf16 ({n_loc}, ..)")
    res_b = distributed_solve(mesh, A, S, torch.stack([f, 0.5 * f]),
                              rtol=1e-3, restart=8, maxiter=40)
    res_ir = distributed_solve(mesh, A, S, f, rtol=1e-5, restart=8,
                               maxiter=40, precision="ir-df32")
    A9, S9, f9 = distributed_setup9(mesh, n, B_PML, WAVE_NUM, CONST, ALPHA,
                                    "c1_f1")
    res9 = distributed_solve(mesh, A9, S9, f9, rtol=1e-3, restart=8,
                             maxiter=60)
    def glob(x):
        grid = x.reshape(*x.shape[:-1], n_loc, n)
        return comm.all_gather_rows(mesh, grid, grid.dim() - 2).cpu().numpy()

    counts = comm.all_gather_object(mesh, driver._counts_since(before))
    return {
        "it_b": np.asarray(res_b.iterations).tolist(),
        "conv_b": bool(np.all(res_b.converged)),
        "X_b": glob(res_b.x).reshape(2, -1),
        "it_ir": int(res_ir.iterations), "conv_ir": bool(res_ir.converged),
        "x_ir": glob(res_ir.x).ravel(),
        "it9": int(res9.iterations), "conv9": bool(res9.converged),
        "x9": glob(res9.x).ravel(),
        "rank_launches": counts,
    }


@torch.no_grad()
def dryrun_multichip(n_devices: int, *, n: int | None = None,
                     device="cuda") -> dict:
    """Run the legs above at n = 16 * n_devices (or `n`) and check them;
    raises AssertionError on a mismatch.  Returns the counts, the errors
    and each rank's kernel launches."""
    from .. import driver
    from .._device import resolve_device
    from .launch import run_ranks

    dev = resolve_device(device)
    n = n or 16 * n_devices
    b = B_PML
    driver._set_full_float32()
    cd = driver.default_complex_dtype(dev)
    stage = dict(n=n, b=b, problem="c1_f1", fidelity="corrected", cdtype=cd,
                 device=dev)
    A, hm, f = driver._assemble_stage(WAVE_NUM, CONST, ALPHA, **stage)
    P = driver._factor_stage(A, hm, b=b, hf_full_coupling=True,
                             d2_replace=True, setup_chunk=128,
                             g_dtype="bf16", device=dev)
    solve = dict(use_precond=True, device=dev)
    ref = driver._solve_stage(A, P, f, 1e-3, restart=8, maxiter=40, **solve)
    ref_ir = driver._solve_stage(A, P, f, 1e-5, restart=8, maxiter=40,
                                 precision="ir-df32", **solve)
    A9, f9, P9 = driver._setup9_stage(
        WAVE_NUM, CONST, ALPHA, 2.0 / 3.0, factor_stride=1, **stage)
    ref9 = driver._solve_stage(A9, P9, f9, 1e-3, restart=8, maxiter=60,
                               **solve)
    assert ref.converged and ref_ir.converged and ref9.converged, \
        "single-card reference solves must converge"
    x_ref = ref.x.cpu().numpy()
    del P, P9, hm

    out = run_ranks(_ranks, n_devices, device=dev, n=n, n_devices=n_devices)
    assert out["conv_b"], "batched distributed solve did not converge"
    assert all(abs(i - ref.iterations) <= 1 for i in out["it_b"]), \
        f"batched dist iterations {out['it_b']} != single-card " \
        f"{ref.iterations} (+-1)"
    err0 = _rel(out["X_b"][0], x_ref)
    err1 = _rel(out["X_b"][1], 0.5 * x_ref)
    assert err0 < 5e-3 and err1 < 5e-3, \
        f"batched dist solutions diverge from single-card: {err0}, {err1}"
    assert out["conv_ir"], "distributed ir-df32 solve did not converge"
    assert abs(out["it_ir"] - ref_ir.iterations) <= 1, \
        f"dist ir-df32 iterations {out['it_ir']} != single-card " \
        f"{ref_ir.iterations} (+-1)"
    err_ir = _rel(out["x_ir"], ref_ir.x.cpu().numpy())
    assert err_ir < 1e-3, \
        f"dist ir-df32 solution diverges from single-card: {err_ir}"
    assert out["conv9"], "distributed 9pt solve did not converge"
    assert abs(out["it9"] - ref9.iterations) <= 1, \
        f"dist 9pt iterations {out['it9']} != single-card " \
        f"{ref9.iterations} (+-1)"
    err9 = _rel(out["x9"], ref9.x.cpu().numpy())
    assert err9 < 5e-3, f"dist 9pt solution diverges from single-card: " \
        f"{err9}"
    return {
        "n": n, "devices": n_devices,
        "iterations": {"batched": out["it_b"], "ir_df32": out["it_ir"],
                       "nine": out["it9"]},
        "single_card": {"batched": ref.iterations,
                        "ir_df32": ref_ir.iterations,
                        "nine": ref9.iterations},
        "errors": {"batched": [err0, err1], "ir_df32": err_ir,
                   "nine": err9},
        "rank_launches": out["rank_launches"],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--devices", type=int, default=4)
    ap.add_argument("--n", type=int, default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    out = dryrun_multichip(args.devices, n=args.n, device=args.device)
    print(json.dumps({k: v for k, v in out.items() if k != "rank_launches"}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
