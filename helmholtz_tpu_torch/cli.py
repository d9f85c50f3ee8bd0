"""Command-line interface of the port, with the JAX package's subcommands,
flags and exit codes (`helmholtz_tpu/cli.py`):

  python -m helmholtz_tpu_torch solve --n 127 --wave-num 16 --const 81
  python -m helmholtz_tpu_torch solve --device cpu --n 31 --b 8 --wave-num 2 --const 30
  python -m helmholtz_tpu_torch sweep --ns 127 255 511 1023
  python -m helmholtz_tpu_torch multisolve --n 1023 --freqs 128 64 --multi-rhs 4
  python -m helmholtz_tpu_torch plan --n 2047 --stencil 9pt
  python -m helmholtz_tpu_torch bench-spmv --n 1023

Every subcommand that computes takes `--device {cuda,cpu}` (default cuda),
the JAX package's `--platform`: it becomes `device=` on every call, and the
card is never replaced by the CPU unless `--device cpu` is given (without a
card the default raises).  Left out, because they are the JAX package's
accelerator workarounds: `--method gmres-hostloop` and `--schur-block`.
`multisolve --mesh D` runs the distributed path on D ranks, one process
each (`dist.launch`: on the card NCCL when every rank has a card of its
own, gloo otherwise; gloo on the CPU).  The module imports nothing heavy
until a subcommand runs, so `--help` needs no card.
"""
from __future__ import annotations

import argparse
import json
import sys

def _add_device_arg(p):
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"],
                   help="where the solve runs (default cuda; without a card "
                        "this raises unless --device cpu is given, which "
                        "runs the plain PyTorch path in complex128)")


def _add_problem_args(p):
    p.add_argument("--n", type=int, default=127, help="interior grid size")
    p.add_argument("--b", type=int, default=12, help="PML width (points)")
    p.add_argument("--wave-num", type=float, default=16.0,
                   help="omega / 2pi")
    p.add_argument("--const", type=float, default=81.0,
                   help="PML amplitude C")
    p.add_argument("--alpha", type=float, default=2.0,
                   help="imaginary frequency shift")
    p.add_argument("--problem", default="c1_f1",
                   choices=["c1_f1", "c1_f2", "c2_f1", "c2_f2"])
    p.add_argument("--fidelity", default="corrected",
                   choices=["as-shipped", "corrected"],
                   help="velocity-sampling convention")
    _add_device_arg(p)


def _add_solver_args(p):
    p.add_argument("--precond", default="moving_pml",
                   choices=["moving_pml", "recompute", "exact", "none"])
    p.add_argument("--method", default="gmres", choices=["gmres", "bicgstab"],
                   help="Krylov method (the JAX package's gmres-hostloop, "
                        "an accelerator workaround, is not ported)")
    p.add_argument("--rtol", type=float, default=1e-3)
    p.add_argument("--restart", type=int, default=20)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--as-shipped-d2", action="store_true",
                   help="reproduce deviation D2 (subtract diag step)")
    p.add_argument("--block-diag-hf", action="store_true",
                   help="reproduce deviation D3 (block-diagonal H_F)")
    p.add_argument("--precision", default="f32",
                   choices=["f32", "ir-df32"],
                   help="ir-df32: iterative refinement in complex128 around "
                        "the complex64 solve, to reach rtol <= 1e-6 on the "
                        "card")
    p.add_argument("--precond-refine", type=int, default=0, metavar="K",
                   help="K Newton-refinement steps of the preconditioner "
                        "solve per application (squares ||I - MA||)")
    p.add_argument("--inner-rtol", type=float, default=1e-2,
                   help="per-cycle tolerance of the ir-df32 inner solver")
    p.add_argument("--g-dtype", default="working",
                   choices=["working", "f32", "bf16"],
                   help="storage type of the factor stack G: bf16 halves "
                        "its memory and the apply's traffic at unchanged "
                        "iteration counts (measured)")
    p.add_argument("--factor-stride", type=int, default=None, metavar="R",
                   help="factor every R-th subgrid, lerp corner inverses "
                        "between samples (default auto: clip(n/128, 1, 8) "
                        "on the card, exact 1 on the CPU; iteration parity "
                        "is the guard)")
    p.add_argument("--g-compress", action="store_true",
                   help="store only the sampled corner inverses and lerp "
                        "the bracketing panels inside the sweep kernel: "
                        "factor memory AND per-apply G traffic drop "
                        "~factor_stride-fold")
    p.add_argument("--no-dedup-hm", action="store_true",
                   help="disable the shared-G collapse for row-invariant "
                        "velocity fields (c2 problems under corrected "
                        "sampling factor ONE subgrid by default)")
    p.add_argument("--stencil", default="5pt", choices=["5pt", "9pt"],
                   help="discretization: 5pt = the reference scheme; 9pt "
                        "= compact 9-point blend solved with its own "
                        "moving-PML sweeping preconditioner "
                        "(precond.sweeping9)")
    p.add_argument("--stencil-gamma", type=float, default=2.0 / 3.0,
                   help="9-point axis/diagonal blend weight (1 = 5-point "
                        "cross; 2/3 = classical compact scheme)")


def _add_output_args(p):
    p.add_argument("--plot", metavar="PNG", help="save Re(u) heatmap")
    p.add_argument("--plot-residuals", metavar="PNG")
    p.add_argument("--metrics", metavar="JSONL",
                   help="append metrics JSON line")
    p.add_argument("--save", metavar="NPZ", help="save solution + history")
    p.add_argument("--save-precond", metavar="NPZ",
                   help="checkpoint the factored preconditioner state")
    p.add_argument("--profile", metavar="DIR",
                   help="capture a torch.profiler trace of the solve "
                        "(assemble/factor/solve ranges) into DIR")
    p.add_argument("--quiet", action="store_true")


def _solve_one(args):
    from .driver import run_solver

    return run_solver(
        args.n, args.b, args.wave_num, args.const, args.alpha,
        problem=args.problem, rtol=args.rtol, restart=args.restart,
        maxiter=args.maxiter, method=args.method, precond=args.precond,
        fidelity=args.fidelity,
        precision=args.precision,
        precond_refine=args.precond_refine,
        inner_rtol=args.inner_rtol,
        g_dtype=args.g_dtype,
        factor_stride=args.factor_stride,
        g_compress=args.g_compress,
        dedup_hm=(False if args.no_dedup_hm else None),
        hf_full_coupling=not args.block_diag_hf,
        d2_replace=not args.as_shipped_d2,
        stencil=args.stencil, stencil_gamma=args.stencil_gamma,
        device=args.device)


def cmd_solve(args):
    from .utils.logging import log_metrics

    if getattr(args, "profile", None):
        from .utils.profiling import trace

        with trace(args.profile):
            r = _solve_one(args)
        print(f"wrote profiler trace to {args.profile}")
    else:
        r = _solve_one(args)
    if not args.quiet:
        print(f"GMRES iterations with preconditioner: {r.iterations}")
        print(f"true relative residual: {r.true_residual:.3e}")
        print(f"Initialization time = {r.init_time:.3f}")
        print(f"{'BiCGStab' if args.method == 'bicgstab' else 'GMRES'} "
              f"solve time = {r.solve_time:.3f}")
    if args.metrics:
        log_metrics(r, args.metrics)
    if args.plot:
        from . import viz
        viz.plot_solution(r, args.plot)
        print(f"wrote {args.plot}")
    if args.plot_residuals:
        from . import viz
        viz.plot_residual_history(r, args.plot_residuals)
        print(f"wrote {args.plot_residuals}")
    if args.save:
        from .utils.checkpoint import save_report
        save_report(args.save, r)
        print(f"wrote {args.save}")
    if args.save_precond:
        from .driver import build_preconditioner
        from .utils.checkpoint import save_preconditioner
        P, _, _ = build_preconditioner(
            args.n, args.b, args.wave_num, args.const, args.alpha,
            problem=args.problem, fidelity=args.fidelity,
            hf_full_coupling=not args.block_diag_hf,
            d2_replace=not args.as_shipped_d2, device=args.device)
        save_preconditioner(args.save_precond, P)
        print(f"wrote {args.save_precond}")
    return 0 if r.converged else 1


def cmd_sweep(args):
    """The reference's n = 127..1023 c1_f1 experiment sweep."""
    from .utils.logging import log_metrics

    # reference-tuned C per n for c1_f1
    default_C = {127: 81.0, 255: 62.0, 511: 81.0, 1023: 100.0}
    init_ts, solve_ts = [], []
    for n in args.ns:
        args.n = n
        if args.scale_freq:
            args.wave_num = (n + 1) / 8.0   # fixed points-per-wavelength
        args.const = default_C.get(n, args.const)
        r = _solve_one(args)
        init_ts.append(r.init_time)
        solve_ts.append(r.solve_time)
        print(f"n={n}: iters={r.iterations} converged={r.converged} "
              f"true_res={r.true_residual:.2e} init={r.init_time:.2f}s "
              f"solve={r.solve_time:.2f}s")
        if args.metrics:
            log_metrics(r, args.metrics)
    if args.plot:
        from . import viz
        viz.plot_runtime(init_ts, solve_ts, args.ns, args.plot,
                         title=f"Runtime {args.problem}")
        print(f"wrote {args.plot}")
    return 0


def cmd_multisolve(args):
    """Multi-frequency sweep with batched-RHS (multi-source) solves per
    frequency, one JSON record per frequency.  With --checkpoint, completed
    frequencies are recorded and skipped when the sweep is restarted after
    a kill (`solve.resumable.SweepCheckpoint`)."""
    from .driver import multisolve_key_config, run_multisolve
    from .solve.resumable import SweepCheckpoint

    ckpt = SweepCheckpoint(args.checkpoint or "")
    consts = args.consts or [100.0] * len(args.freqs)
    if len(consts) == 1:
        consts = consts * len(args.freqs)
    if len(consts) != len(args.freqs):
        raise SystemExit(f"--consts got {len(consts)} values for "
                         f"{len(args.freqs)} --freqs")
    # the FULL run-defining configuration (the normalization run_multisolve
    # stamps into every record), so a checkpoint written under another
    # stencil, preconditioner or precision never matches
    template = multisolve_key_config(
        args.n, args.b, args.problem, args.rtol, args.multi_rhs,
        fidelity=args.fidelity, g_dtype=args.g_dtype,
        factor_stride=args.factor_stride, g_compress=args.g_compress,
        freq_anchor_every=args.freq_anchor_every,
        precond=args.msolve_precond, stencil=args.stencil,
        stencil_gamma=args.stencil_gamma, mesh_devices=args.mesh,
        precision=args.precision, precond_refine=args.precond_refine,
        device=args.device)
    done = {SweepCheckpoint.key_of(r) for r in ckpt.matching(template)}
    ok = True
    for rec in ckpt.matching(template):
        print(json.dumps(rec))
        ok &= all(rec["converged"])
    kw = dict(alpha=args.alpha, problem=args.problem,
              n_sources=args.multi_rhs, rtol=args.rtol,
              restart=args.restart, maxiter=args.maxiter or 200,
              fidelity=args.fidelity, g_dtype=args.g_dtype,
              factor_stride=args.factor_stride, g_compress=args.g_compress,
              precond=args.msolve_precond, stencil=args.stencil,
              stencil_gamma=args.stencil_gamma, mesh_devices=args.mesh,
              precision=args.precision,
              precond_refine=args.precond_refine, device=args.device)

    def emit(rec):
        ckpt.add(rec)
        print(json.dumps(rec))
        if args.metrics:
            with open(args.metrics, "a") as fh:
                fh.write(json.dumps(rec) + "\n")
        return all(rec["converged"])

    if args.freq_anchor_every > 1:
        # anchors span the whole list, so the amortized sweep re-runs AS A
        # UNIT whenever anything is missing (an intermediate needs both its
        # anchors factored, and dropping completed frequencies would
        # re-choose the anchors over the leftover subset), and only the
        # missing records are emitted and appended
        missing = [wn for wn, C in zip(args.freqs, consts)
                   if SweepCheckpoint.key_of(
                       {**template, "wave_num": float(wn),
                        "const": float(C)}) not in done]
        if missing:
            recs = run_multisolve(
                args.n, args.b, list(args.freqs), consts=consts,
                freq_anchor_every=args.freq_anchor_every, **kw)
            for rec in recs:
                if SweepCheckpoint.key_of(
                        {**template, "wave_num": rec["wave_num"],
                         "const": rec["const"]}) in done:
                    continue
                ok &= emit(rec)
        return 0 if ok else 1

    for wn, C in zip(args.freqs, consts):
        key = SweepCheckpoint.key_of({**template, "wave_num": float(wn),
                                      "const": float(C)})
        if key in done:
            continue
        [rec] = run_multisolve(args.n, args.b, [wn], consts=[C], **kw)
        ok &= emit(rec)
    return 0 if ok else 1


def cmd_bench_scaling(args):
    """Scaling efficiency of the distributed path at 1..K ranks
    (`bench.scaling`)."""
    from .bench.scaling import main as scaling_main

    argv = ["--strong-n", str(args.n), "--b", str(args.b),
            "--ndevs", *map(str, args.ndevs), "--device", args.device]
    if args.anchor:
        argv.append("--anchor")
    if args.out:
        argv += ["--out", args.out]
    return scaling_main(argv)


def cmd_bench_sweep(args):
    from .bench.roofline import measure_sweep

    print(json.dumps(measure_sweep(args.n, b=args.b, device=args.device)))
    return 0


def cmd_bench_spmv(args):
    from .bench.roofline import measure_spmv

    print(json.dumps(measure_spmv(args.n, device=args.device)))
    return 0


def cmd_plan(args):
    from .bench.plan import main as plan_main

    return plan_main(["--n", str(args.n), "--b", str(args.b),
                      "--batch", str(args.batch), "--hbm-gb",
                      str(args.hbm_gb), "--g-dtype", args.g_dtype,
                      "--stencil", args.stencil, "--device", args.device])


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="helmholtz_tpu_torch",
        description="2-D Helmholtz solves with the moving-PML sweeping "
                    "preconditioner on one NVIDIA H100 (the PyTorch/CUDA "
                    "port).",
        epilog="Not ported: --method gmres-hostloop and --schur-block "
               "(accelerator workarounds of the JAX package); "
               "multisolve --mesh and bench-scaling run the distributed "
               "path, one process per rank.")
    sub = ap.add_subparsers(dest="cmd", required=True)

    p = sub.add_parser("solve", help="single preconditioned solve")
    _add_problem_args(p)
    _add_solver_args(p)
    _add_output_args(p)
    p.set_defaults(fn=cmd_solve)

    p = sub.add_parser("sweep", help="reference experiment sweep")
    _add_problem_args(p)
    _add_solver_args(p)
    _add_output_args(p)
    p.add_argument("--ns", type=int, nargs="+",
                   default=[127, 255, 511, 1023])
    p.add_argument("--scale-freq", action="store_true", default=True,
                   help="scale omega/2pi = (n+1)/8 with n (reference sweep)")
    p.set_defaults(fn=cmd_sweep)

    p = sub.add_parser("multisolve",
                       help="multi-frequency + batched-RHS sweep")
    _add_problem_args(p)
    p.add_argument("--freqs", type=float, nargs="+",
                   default=[16.0, 32.0], help="omega/2pi values")
    p.add_argument("--consts", type=float, nargs="+", default=None,
                   help="PML C per frequency (default: 100 each)")
    p.add_argument("--multi-rhs", type=int, default=4,
                   help="number of batched source positions per frequency")
    p.add_argument("--rtol", type=float, default=1e-3)
    p.add_argument("--restart", type=int, default=20)
    p.add_argument("--maxiter", type=int, default=None)
    p.add_argument("--mesh", type=int, default=None, metavar="D",
                   help="the distributed path: the grid rows in bands over "
                        "D ranks (D must divide n, and b < n/D)")
    p.add_argument("--g-dtype", default="working",
                   choices=["working", "f32", "bf16"])
    p.add_argument("--precision", default="f32", choices=["f32", "ir-df32"])
    p.add_argument("--precond-refine", type=int, default=0)
    p.add_argument("--factor-stride", type=int, default=None, metavar="R",
                   help="factor every R-th subgrid per frequency "
                        "(default auto)")
    p.add_argument("--g-compress", action="store_true",
                   help="sample-compressed factor storage (capacity "
                        "layout; required by --freq-anchor-every)")
    p.add_argument("--freq-anchor-every", type=int, default=1, metavar="K",
                   help="factor only every K-th frequency of the "
                        "ascending sweep (plus the last); in between the "
                        "compressed G samples are the omega-lerp of the "
                        "bracketing anchors")
    p.add_argument("--precond", dest="msolve_precond", default="moving_pml",
                   choices=["moving_pml", "recompute"],
                   help="recompute: factor-free capacity path; the batch "
                        "shares each chunk's re-factorization")
    p.add_argument("--stencil", default="5pt", choices=["5pt", "9pt"],
                   help="9pt: batched sources through the 9-point scheme "
                        "and its own sweeping preconditioner")
    p.add_argument("--stencil-gamma", type=float, default=2.0 / 3.0)
    p.add_argument("--metrics", metavar="JSONL")
    p.add_argument("--checkpoint", metavar="JSONL",
                   help="sweep progress file: completed frequencies are "
                        "skipped on restart")
    p.set_defaults(fn=cmd_multisolve)

    p = sub.add_parser("bench-scaling",
                       help="solve-time scaling efficiency at 1..K ranks "
                            "of the distributed path")
    p.add_argument("--n", type=int, default=64)
    p.add_argument("--b", type=int, default=3)
    p.add_argument("--ndevs", type=int, nargs="+", default=[1, 2, 4, 8])
    p.add_argument("--anchor", action="store_true",
                   help="include the one-rank anchors against the "
                        "single-card apply and setup (on the card)")
    p.add_argument("--out", metavar="JSON")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench_scaling)

    p = sub.add_parser("plan",
                       help="memory budget / device count for a grid size")
    p.add_argument("--n", type=int, required=True)
    p.add_argument("--b", type=int, default=12)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--hbm-gb", type=float, default=80.0,
                   help="device memory when --device cpu (with --device "
                        "cuda the card's own is read)")
    p.add_argument("--g-dtype", default="f32",
                   choices=["f32", "bf16", "working"])
    p.add_argument("--stencil", default="5pt", choices=["5pt", "9pt"],
                   help="9pt: budget the 9-point layout (b ~ n/14 recipe, "
                        "sampled-family setup)")
    _add_device_arg(p)
    p.set_defaults(fn=cmd_plan)

    p = sub.add_parser("bench-spmv",
                       help="stencil-product roofline measurement")
    p.add_argument("--n", type=int, default=1023)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench_spmv)

    p = sub.add_parser("bench-sweep",
                       help="preconditioner-apply roofline measurement")
    p.add_argument("--n", type=int, default=1023)
    p.add_argument("--b", type=int, default=12)
    _add_device_arg(p)
    p.set_defaults(fn=cmd_bench_sweep)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
