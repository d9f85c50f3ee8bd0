"""The control of the check: the program in TF32.

    python3 portbench/control.py --workload <cell> --seeds <s> [<s> ...]

The configurations state float32 (complex64) with TF32 off; the nearest
precision below is TF32.  For each seed it drives `harness.run_cell` at the
cell's own size over a window of the cell's first `check_requests` requests
(so that every one of them is checked, as many as a run checks), three
times:

* "program": as the configuration states;
* "tf32": the program's own TF32 path switched on
  (`torch.backends.cuda.matmul.allow_tf32`, which `run_cell` sets from the
  configuration's `tf32` and which the port's cuBLAS products follow);
* "tf32_operator": the operator product, the stencil kernel, fed its
  vectors in TF32 (10-bit mantissa, rounded to nearest) as a tensor-core
  product would take them.

One JSON line for each: `correct`, each number the check compared beside
its limit, and GMRES's mean iterations a right-hand side.  The benchmark's
own runs do not run it.
"""
import argparse
import json
import pathlib
import sys
import time

HERE = pathlib.Path(__file__).resolve().parent
ITERS = {"name": "krylov.iters_per_rhs", "unit": "iters"}


def round_tf32(V):
    """complex64 values rounded to TF32's 10-bit mantissa (to nearest)."""
    import torch
    bits = V.contiguous().view(torch.float32).view(torch.int32)
    bits = (bits + 0x1000) & -0x2000
    return bits.view(torch.float32).view(torch.complex64).reshape(V.shape)


def gather_tf32_operator(cfg, wave_num, xs, ys, **kw):
    """`entry.gather` with the stencil kernel fed TF32 vectors."""
    import entry
    product = entry.stencil_matvec_flat
    entry.stencil_matvec_flat = lambda A, v: product(A, round_tf32(v))
    try:
        return entry.gather(cfg, wave_num, xs, ys, **kw)
    finally:
        entry.stencil_matvec_flat = product


def readings(cell: dict, cfg: dict, mix: dict, limits: dict, seed: int, *,
             device) -> dict:
    """{"program": ..., "tf32": ..., "tf32_operator": ...}:
    `harness.run_cell`'s result over the first `check_requests` requests of
    `seed`, as configured, with the TF32 path on, and with the operator
    product fed TF32."""
    import entry
    import harness
    out = {}
    for name, tf32, gather in (
            ("program", bool(cfg["tf32"]), entry.gather),
            ("tf32", True, entry.gather),
            ("tf32_operator", bool(cfg["tf32"]), gather_tf32_operator)):
        t0 = time.perf_counter()
        r = harness.run_cell(
            cell, {**cfg, "tf32": tf32}, mix, limits, seed=seed, seconds=0.0,
            min_requests=int(mix["check_requests"]), trace=False,
            metric_defs=[ITERS], device=device, t_start=t0, gather=gather)
        r["seconds"] = time.perf_counter() - t0
        out[name] = r
    return out


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args()
    sys.path[:0] = [str(HERE), str(HERE.parent)]
    import torch
    if not torch.cuda.is_available():
        sys.exit("control.py: no card")
    import check
    import traffic
    bench = json.loads((HERE.parent / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[args.workload]
    cfile = {c["name"]: c for c in bench["configs"]}[cell["config"]]["file"]
    cfg = json.loads((HERE.parent / cfile).read_text())
    mix = traffic.load(cell["traffic"])
    limits = check.load_limits(args.workload)
    for seed in args.seeds:
        for name, r in readings(cell, cfg, mix, limits, seed,
                                device="cuda").items():
            print(json.dumps({
                "workload": args.workload, "seed": seed, "run": name,
                "correct": r["correct"], "check": r["check"],
                "iters_per_rhs": r["metrics"].get(ITERS["name"],
                                                  {}).get("value"),
                "requests": r["requests"], "attempted": r["attempted"],
                "seconds": r["seconds"]}), flush=True)


if __name__ == "__main__":
    main()
