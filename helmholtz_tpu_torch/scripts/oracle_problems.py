"""complex128 scipy oracle rows for the reference's other three problems.

The reference's experiment matrix has four problems, c{1,2} x f{1,2}:
c1 the Gaussian velocity, c2 the velocity that varies along the rows only;
f1 the point-like source, f2 the directed Gaussian beam.  `ORACLE.json`
holds rows for c1_f1; this script writes the same rows for c1_f2, c2_f1
and c2_f2 with the port's own oracle (`bench.ref_oracle`: the port's CPU
assembly in complex128, SuperLU for H_F and every subgrid, scipy GMRES),
at the reference sweep's configuration: b = 12, omega/2pi = (n+1)/8 and
the reference's C for that n.  Nothing here touches the card.

    python -m helmholtz_tpu_torch.scripts.oracle_problems \
        --out ORACLE_PROBLEMS.jsonl
    python -m helmholtz_tpu_torch.scripts.oracle_problems --impl port \
        --problems c2_f1 --ns 2047 --rtols 1e-3 \
        --out PORT_REFERENCE_n2047.jsonl

Each row carries the keys of `ORACLE.json` plus `problem` and `host` (the
machine and interpreter that ran it).  The default set (three problems x
n = 511, 1023 x rtol 1e-3, 1e-6) took 9.9 minutes on an 8-core x86 host
and held 17.4 GB at its peak (n = 1023 factors 1,011 subgrids).  Rows
already in `--out` are kept and not run again, so a cut run resumes.

At n = 2047 the scipy setup, one SuperLU factor a subgrid, would hold
about four times that.  `--impl port` writes the same rows from the port's
own complex128 solve on the CPU (`driver.run_solver(device="cpu")`, held
to the JAX package at small n and to these rows at n <= 1023), whose
row-invariant c2 media factor ONE subgrid (`dedup_hm`): c2_f1 at n = 2047
held 8.6 GB and took 111 s on 6 threads.  Its metrics start with
`port_iters_`.
"""
from __future__ import annotations

import argparse
import json
import os
import platform
import sys
import time

import torch

from ..bench import ref_oracle

PROBLEMS = ("c1_f2", "c2_f1", "c2_f2")
NS = (511, 1023)
RTOLS = (1e-3, 1e-6)
B = 12
#: the reference sweep's PML amplitude for each n (`cli.cmd_sweep`,
#: `bench.ref_oracle.run_oracle`); at 2047 the JAX package's n = 2047
#: records' (CAPACITY_COMPRESSED.jsonl, MULTISOLVE_n2047.jsonl)
REFERENCE_C = {127: 81.0, 255: 62.0, 511: 81.0, 1023: 100.0, 2047: 100.0}
IMPLS = {"scipy": "oracle_iters", "port": "port_iters"}


def metric(problem: str, n: int, impl: str = "scipy") -> str:
    """The prefix of a row's `metric`; `_rtol<rtol>` follows it."""
    return f"{IMPLS[impl]}_{problem}_n{n}"


def host() -> str:
    return (f"{platform.machine()} {platform.processor() or 'cpu'}, "
            f"{os.cpu_count()} cores, torch {torch.__version__}, "
            f"{torch.get_num_threads()} threads")


def oracle_rows(problem: str, n: int, rtols=RTOLS, *, b: int = B,
                alpha: float = 2.0, restart: int = 20,
                maxiter: int = 200) -> list:
    """One row per tolerance for `problem` at grid size n: scipy GMRES(20)
    with the SuperLU corrected sweep as M."""
    wave_num = (n + 1) / 8.0
    const = REFERENCE_C.get(n, 81.0)
    t0 = time.time()
    A_sp, f_vec, lu_HF, lus, a_cs, a_cn = ref_oracle._setup_scipy(
        n, b, wave_num, const, alpha, problem=problem)
    setup_s = time.time() - t0
    return ref_oracle._gmres_records(
        A_sp, f_vec, ref_oracle.make_apply(n, b, lu_HF, lus, a_cs, a_cn),
        prefix=metric(problem, n),
        fields={"problem": problem, "n": n, "b": b, "wave_num": wave_num,
                "const": const, "host": host()},
        impl="scipy-superlu-corrected", rtols=rtols, restart=restart,
        maxiter=maxiter, setup_s=setup_s)


def port_rows(problem: str, n: int, rtols=RTOLS, *, b: int = B,
              alpha: float = 2.0) -> list:
    """The same rows from the port's own complex128 solve on the CPU:
    GMRES(20) with the corrected sweep at stride 1 (`run_solver`'s CPU
    defaults), one factored subgrid for the row-invariant c2 media."""
    from ..driver import run_solver

    wave_num = (n + 1) / 8.0
    const = REFERENCE_C.get(n, 81.0)
    rows = []
    for rtol in rtols:
        r = run_solver(n, b, wave_num, const, alpha, problem=problem,
                       rtol=rtol, device="cpu")
        row = {"metric": f"{metric(problem, n, 'port')}_rtol{rtol:g}",
               "problem": problem, "n": n, "b": b, "wave_num": wave_num,
               "const": const, "host": host(), "rtol": rtol,
               "iters": r.iterations, "info": 0 if r.converged else 1,
               "true_residual": r.true_residual,
               "setup_s": round(r.init_time, 1),
               "solve_s": round(r.solve_time, 1), "dtype": r.config["dtype"],
               "impl": "port-cpu-corrected", "dedup_hm": r.config["dedup_hm"],
               "factor_stride": r.config["factor_stride"]}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="helmholtz_tpu_torch.scripts.oracle_problems",
        description=__doc__.split("\n\n")[0])
    ap.add_argument("--problems", nargs="+", default=list(PROBLEMS),
                    choices=["c1_f1", "c1_f2", "c2_f1", "c2_f2"])
    ap.add_argument("--ns", type=int, nargs="+", default=list(NS))
    ap.add_argument("--rtols", type=float, nargs="+", default=list(RTOLS))
    ap.add_argument("--impl", default="scipy", choices=sorted(IMPLS),
                    help="scipy: the SuperLU oracle; port: the port's own "
                         "complex128 solve on the CPU")
    ap.add_argument("--out", default="ORACLE_PROBLEMS.jsonl",
                    help="JSON lines file the rows are appended to")
    args = ap.parse_args(argv)
    rows_of = oracle_rows if args.impl == "scipy" else port_rows
    done = set()
    if os.path.exists(args.out):
        with open(args.out) as fh:
            done = {json.loads(line)["metric"] for line in fh if line.strip()}
    for problem in args.problems:
        for n in args.ns:
            rtols = [r for r in args.rtols if
                     f"{metric(problem, n, args.impl)}_rtol{r:g}" not in done]
            if not rtols:
                continue
            rows = rows_of(problem, n, rtols)
            with open(args.out, "a") as fh:
                for row in rows:
                    fh.write(json.dumps(row) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
