"""Measure the preconditioner setup against the batched-inverse chunk.

    python3 -m helmholtz_tpu_torch.scripts.measure_setup_chunk [--n 1023]

For each chunk size the layer-Schur recursion (b batched inverses of
chunk x n x n complex64 matrices) runs on that many moving-PML subgrids of
the c1_f1 problem; the script prints seconds per subgrid and the peak device
memory, one JSON line per chunk, after a line with the card's name and power
limit.  With `--solve-chunks` it then times the whole init stage (assembly +
factorization) of the full solve, `run_solver(n, b, n/8, 100, g_dtype="bf16")`,
at each of those `setup_chunk` values, in the order given and back again.
The value of `precond.sweeping.SETUP_WORKSPACE_WORDS` was chosen from this
output.  Needs one CUDA device.
"""
import argparse
import json
import subprocess
import sys
import time

import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.precond import sweeping


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=1023)
    parser.add_argument("--b", type=int, default=12)
    parser.add_argument("--chunks", type=int, nargs="+",
                        default=[4, 8, 16, 30, 61, 146])
    parser.add_argument("--solve-chunks", type=int, nargs="*", default=[],
                        help="setup_chunk values for whole-solve init times")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure_setup_chunk needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    print(json.dumps({"card": smi, "n": args.n, "b": args.b}), flush=True)

    n, b = args.n, args.b
    cfg = ht.HelmholtzConfig(n=n, b=b, wave_num=n / 8.0, const=100.0)
    prob = ht.assemble_problem(cfg, "c1_f1")
    rows = torch.arange(b, b + max(args.chunks), device="cuda")
    hm = fd_stencil.build_hm_stencils_rows(
        rows, n, b, cfg.const, cfg.eta, cfg.omega, cfg.h, prob.c_full,
        fidelity="corrected", complex_dtype=torch.complex64)
    with torch.no_grad():
        sweeping._schur_corner_inverse(hm.map(lambda f: f[:2]))   # warm up
        for chunk in args.chunks:
            part = hm.map(lambda f: f[:chunk])
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            T = sweeping._schur_corner_inverse(part)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            peak = torch.cuda.max_memory_allocated() - base
            del T
            print(json.dumps({
                "chunk": chunk, "seconds": dt,
                "seconds_per_subgrid": dt / chunk,
                "ms_per_inverse": dt / (chunk * b) * 1e3,
                "workspace_peak_bytes": peak,
                "complex_words": chunk * n * n}), flush=True)
    del hm, part, prob
    for chunk in args.solve_chunks + args.solve_chunks[::-1]:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats()
        rep = ht.run_solver(n, b, n / 8.0, 100.0, rtol=1e-3, maxiter=60,
                            g_dtype="bf16", setup_chunk=chunk)
        print(json.dumps({
            "setup_chunk": chunk,
            "clamped": sweeping._clamped_chunk(chunk, n),
            "init_time_s": rep.init_time, "solve_time_s": rep.solve_time,
            "iterations": rep.iterations,
            "peak_bytes": torch.cuda.max_memory_allocated()}), flush=True)


if __name__ == "__main__":
    main()
