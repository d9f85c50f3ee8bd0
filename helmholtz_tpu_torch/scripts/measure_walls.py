"""Walls of the paths a kernel change may move, and the host cost of one
sweep call, for the package of a given tree.

    python3 helmholtz_tpu_torch/scripts/measure_walls.py [--root DIR]
        [--label NAME] [--reps 20]

Imports `helmholtz_tpu_torch` from DIR (default: the checkout that holds
this script), so that one script times two trees of the package, such as a
commit and its parent unpacked with `git archive`: run it once a tree, in
turns (parent, change, change, parent, ...), in one call on one card.  It
uses only what every slice of the port has: `run_solver`,
`run_multisolve` and the sweep wrapper `ops.kernels.sweep.sweep`.

It builds the tree's kernels (unless built), warms up with the n = 127
solve, then prints one JSON line each for:

  sweep_call  one sweep through the wrapper, bf16 G at n = 1023: 5-point
              fwd at R = 1 (1,010 steps), 9-point tri fwd at R = 1 (948
              steps), and compressed-G bwd at R = 4 (1,011 steps).  Medians
              over --reps calls, each started on an idle device: `host_ms`
              from the call to its return, `done_ms` from the call to the
              end of the device's work (`torch.cuda.synchronize()`);
  solve9      run_solver, 9-point, n = 1023, b = 74, C = 60, rtol 1e-3;
  exact       run_solver, n = 511, precond="exact";
  amortized   run_multisolve, n = 1023, five frequencies x four sources,
              compressed G, an anchor factorization every fourth frequency;

the paths with the configurations of `chip_smoke.py` (NINE, EXACT,
AMORTIZED): init and solve walls in s (the entry points' own host clocks,
which end in a synchronize), iterations and true residuals.  The first and
the last line give the card's name and power limit and the file the
package came from.  Needs one CUDA device.
"""
import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

NINE = dict(n=1023, b=74, wave_num=128.0, const=60.0, problem="c1_f1",
            stencil="9pt", rtol=1e-3, restart=20, maxiter=60, g_dtype="bf16")
EXACT = dict(n=511, b=12, wave_num=64.0, const=81.0, problem="c1_f1",
             precond="exact", rtol=1e-3)
SMALL = dict(n=127, b=12, wave_num=16.0, const=81.0, problem="c1_f1",
             rtol=1e-3, g_dtype="f32", factor_stride=1)
AMORTIZED = dict(wave_nums=[126.0, 126.5, 127.0, 127.5, 128.0],
                 consts=[100.0], n_sources=4, rtol=1e-3, g_dtype="bf16",
                 factor_stride=7, g_compress=True, freq_anchor_every=4)
N, B5, STRIDE = 1023, 12, 7


def say(what, **fields):
    print(json.dumps({"measure": what, **fields}), flush=True)


def solve_with(ht, cfg):
    return ht.run_solver(cfg["n"], cfg["b"], cfg["wave_num"], cfg["const"],
                         **{k: v for k, v in cfg.items()
                            if k not in ("n", "b", "wave_num", "const")})


def sweep_call_ms(torch, k2, args, kw, reps):
    """Medians of the host time of one call and of its time to done."""
    k2.sweep(*args, **kw)
    torch.cuda.synchronize()
    host, done = [], []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        k2.sweep(*args, **kw)
        t1 = time.perf_counter()
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        host.append((t1 - t0) * 1e3)
        done.append((t2 - t0) * 1e3)
    return statistics.median(host), statistics.median(done)


def main():
    here = os.path.dirname(os.path.abspath(__file__))
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        here)), help="the tree whose helmholtz_tpu_torch is timed")
    parser.add_argument("--label", default="", help="a name for the tree")
    parser.add_argument("--reps", type=int, default=20)
    args = parser.parse_args()
    sys.path.insert(0, os.path.abspath(args.root))
    import torch
    if not torch.cuda.is_available():
        print("measure_walls needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import helmholtz_tpu_torch as ht
    from helmholtz_tpu_torch.ops.kernels import build
    from helmholtz_tpu_torch.ops.kernels import sweep as k2
    from helmholtz_tpu_torch.precond import sweeping

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    tree = dict(label=args.label, package=ht.__file__)
    say("card", card=smi, **tree)
    t0 = time.perf_counter()
    build.build()
    build.library()
    say("build", seconds=time.perf_counter() - t0, **tree)
    torch.backends.cuda.matmul.allow_tf32 = False
    rep = solve_with(ht, SMALL)
    say("warm_up", iterations=rep.iterations, **tree)

    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randc(shape):
        return torch.complex(torch.randn(shape, generator=gen, device=dev),
                             torch.randn(shape, generator=gen,
                                         device=dev)) / math.sqrt(2.0)

    def planes(Mg):
        ld = k2.g_ld(N)
        out = []
        for _ in range(2):
            g = torch.zeros((Mg, N, ld), device=dev)
            g[:, :, :N] = torch.randn((Mg, N, N), generator=gen,
                                      device=dev) * (0.25 / math.sqrt(2 * N))
            out.append(g.to(torch.bfloat16))
        return out

    G = planes(N - B5)
    g_w, g_lo = sweeping.compress_tables(N - B5, STRIDE)
    g_lo = torch.from_numpy(g_lo).to(dev)
    g_w = torch.from_numpy(g_w).to(dev)
    samples = [g[:int(g_lo.max()) + 2].contiguous() for g in G]
    S5, S9 = N - B5 - 1, N - NINE["b"] - 1
    c9 = randc((S9, 3, N)) / math.sqrt(3.0)
    cases = (
        ("fwd", G, (randc((S5, N)), randc((S5, N)), randc(N)), {}),
        ("fwd_tri", [g[:S9 + 1] for g in G],
         (randc((S9, N)), c9, randc(N)), {}),
        ("bwd_lerp_R4", samples,
         (randc((S5 + 1, 4, N)), randc((S5 + 1, N)), randc((4, N))),
         dict(g_lo=g_lo, g_w=g_w)))
    for name, (g_re, g_im), (u, c, carry0), kw in cases:
        c[-1] = 0
        host, done = sweep_call_ms(torch, k2, (g_re, g_im, u, c, carry0),
                                   dict(mode=name.split("_")[0], **kw),
                                   args.reps)
        say("sweep_call", case=name, steps=u.shape[0], host_ms=host,
            done_ms=done, reps=args.reps, **tree)
    del G, samples, cases
    torch.cuda.empty_cache()

    for name, cfg in (("solve9", NINE), ("exact", EXACT)):
        rep = solve_with(ht, cfg)
        say(name, init_s=rep.init_time, solve_s=rep.solve_time,
            iterations=rep.iterations, true_residual=rep.true_residual,
            **tree)
    kw = {k: v for k, v in AMORTIZED.items() if k != "wave_nums"}
    recs = ht.run_multisolve(N, B5, AMORTIZED["wave_nums"], **kw)
    say("amortized", init_s=[r["init_time_s"] for r in recs],
        solve_s=[r["solve_time_s"] for r in recs],
        setup_mode=[r.get("setup_mode") for r in recs],
        iterations=[r["iterations"] for r in recs],
        true_residuals=[max(r["true_residuals"]) for r in recs], **tree)
    say("card", card=smi, **tree)


if __name__ == "__main__":
    main()
