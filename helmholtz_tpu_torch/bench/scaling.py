"""Scaling harness of the distributed path: solve time and apply rate at
1..K ranks.

The JAX package's `bench/scaling.py` on the port.  For each rank count D
one launch (`dist.launch.run_ranks`) measures, on every rank at once:

  strong       the distributed solve of a fixed n (`strong_n`);
  weak apply   the staged sweep over a synthetic row-aligned band of
               `rows_per_dev` panels a rank (constant work a rank), one
               right-hand side and a batch of eight;
  weak solve   the distributed solve at n = weak_rows * D, per iteration;
  apply        one staged apply of the strong problem;
  halo         the halo-exchange band product against the same band
               product with no exchange: the share the moves take.

Efficiencies are anchored at the smallest D measured:
  strong:  T_d0 * d0 / (D * T_D);   weak:  T_d0 / T_D.

Times are wall-clock, each rank's device synchronized and the ranks met
at a barrier around every timed region; `_two_point` takes the difference
of k and 5k repetitions, so fixed costs per call cancel.

What the numbers mean depends on where the ranks ran, and every record
says so: `backend` ("cpu-gloo": processes sharing the host's cores;
"cuda-nccl": a card per rank; "cuda-gloo": ranks sharing a card, rows
staged through host memory) and `ranks_per_card`.  Only "cuda-nccl"
times are scaling numbers; the others check the harness and the code
path, and ranks that share one card take turns on it, so their times say
nothing about scaling.

    python -m helmholtz_tpu_torch bench-scaling --device cpu --n 32 --ndevs 1 2 4
"""
from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from .._device import resolve_device


def _sync_all(mesh) -> None:
    from ..dist import comm

    if mesh.device.type == "cuda":
        torch.cuda.synchronize(mesh.device)
    comm.barrier(mesh)


def _timed(mesh, fn, reps: int) -> float:
    """Median seconds of fn() over `reps`, after one warm call."""
    fn()
    ts = []
    for _ in range(reps):
        _sync_all(mesh)
        t0 = time.perf_counter()
        fn()
        _sync_all(mesh)
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def _two_point(mesh, step, iters: int, reps: int) -> float:
    """Seconds per step from the difference of `iters` and 5 * `iters`
    steps, median over `reps`."""
    def run(k):
        for _ in range(k):
            step()

    run(1)
    diffs = []
    for _ in range(reps):
        _sync_all(mesh)
        t0 = time.perf_counter()
        run(iters)
        _sync_all(mesh)
        t1 = time.perf_counter()
        run(5 * iters)
        _sync_all(mesh)
        t2 = time.perf_counter()
        diffs.append(max((t2 - t1) - (t1 - t0), 1e-9) / (4 * iters))
    return float(np.median(diffs))


def _dist_solve(mesh, n, b, *, rtol, reps, wave_num=2.0, const=20.0):
    from ..dist.factor import distributed_setup
    from ..dist.solve import distributed_solve

    A, S, f = distributed_setup(mesh, n, b, wave_num, const, 2.0, "c1_f1")
    out = {}

    def run():
        out["res"] = distributed_solve(mesh, A, S, f, rtol=rtol)

    t = _timed(mesh, run, reps)
    res = out["res"]
    g_bytes = 2 * S.G_re.numel() * S.G_re.element_size()
    return {"n": n, "b": b, "n_devices": mesh.size,
            "iters": int(res.iterations), "converged": bool(res.converged),
            "solve_s": t, "per_device_g_gb": g_bytes / 1e9}, (A, S, f)


def _weak_state(mesh, n, rows, batch):
    """A synthetic band: random G panels and couplings of a fixed (n, n)
    size, `rows` a rank, H_F the identity (b = 1), so every rank does the
    same work at every rank count."""
    from ..dist.partition import DistSweepState
    from ..ops.kernels.sweep import g_ld

    dev = mesh.device
    gen = torch.Generator().manual_seed(mesh.rank)
    rnd = lambda *s: (0.1 * torch.randn(*s, generator=gen)).to(dev)
    cd = torch.complex64 if dev.type == "cuda" else torch.complex128
    rd = torch.float32 if dev.type == "cuda" else torch.float64
    crnd = lambda *s: torch.complex(rnd(*s), rnd(*s)).to(cd)
    G = [torch.zeros((rows, n, g_ld(n)), dtype=rd, device=dev)
         for _ in range(2)]
    for g in G:
        g[:, :, :n] = rnd(rows, n, n).to(rd)
    S = DistSweepState(
        G_re=G[0], G_im=G[1],
        TF=torch.eye(n, dtype=cd, device=dev)[None],
        hf_cs=torch.zeros((1, n), dtype=cd, device=dev),
        hf_cn=torch.zeros((1, n), dtype=cd, device=dev),
        a_cs=crnd(rows, n), a_cn=crnd(rows, n), b=1, d2_replace=True)
    return S, crnd(batch, rows, n)


def _rank_report(device, n_devices, strong_n, weak_rows, b, rtol, reps,
                 weak_n, weak_rows_apply, inner_iters):
    """Every measurement of one rank count, on every rank."""
    from ..dist import comm
    from ..dist.partition import make_mesh
    from ..dist.spmv import halo_stencil_matvec
    from ..dist.sweep import dist_apply_preconditioner
    from ..ops.kernels.spmv_stencil import stencil_matvec

    mesh = make_mesh(n_devices, device=device)
    strong, (A, S, f) = _dist_solve(mesh, strong_n, b, rtol=rtol, reps=reps)
    weak_solve, _ = _dist_solve(mesh, weak_rows * n_devices, b, rtol=rtol,
                                reps=reps)
    weak_solve["solve_s_per_iter"] = (weak_solve["solve_s"]
                                      / max(weak_solve["iters"], 1))
    weak = {}
    for batch in (1, 8):
        Sw, Fw = _weak_state(mesh, weak_n, weak_rows_apply, batch)
        weak[batch] = {
            "n": weak_n, "rows_per_device": weak_rows_apply,
            "n_devices": n_devices, "batch": batch,
            "s_per_apply": _two_point(
                mesh, lambda: dist_apply_preconditioner(mesh, Sw, Fw),
                inner_iters, reps)}
    apply = {"n": strong_n, "b": b, "n_devices": n_devices,
             "s_per_apply": _two_point(
                 mesh, lambda: dist_apply_preconditioner(mesh, S, f),
                 inner_iters, reps)}
    t_halo = _two_point(mesh, lambda: halo_stencil_matvec(mesh, A, f),
                        inner_iters, reps)
    t_local = _two_point(mesh, lambda: stencil_matvec(A, f), inner_iters,
                         reps)
    halo = {"n": strong_n, "n_devices": n_devices, "s_halo_spmv": t_halo,
            "s_local_spmv": t_local,
            "collective_fraction": max(0.0, 1.0 - t_local
                                       / max(t_halo, 1e-12))}
    comm.barrier(mesh)
    return {"strong": strong, "weak_solve": weak_solve, "weak": weak,
            "apply": apply, "halo": halo, "backend": mesh.backend}


def _label(dev, backend) -> str:
    if dev.type == "cpu":
        return "cpu-gloo"
    return f"cuda-{backend}"


def scaling_report(*, strong_n=64, weak_rows_per_dev=16, b=3,
                   ndevs=(1, 2, 4, 8), rtol=1e-3, reps=3, weak_n=64,
                   weak_rows_apply=8, inner_iters=10, device="cuda") -> dict:
    """The scaling record (the JAX package's keys), one launch per rank
    count; every series' records carry `backend` and `ranks_per_card`."""
    from ..dist.launch import choose_backend, ranks_per_card, run_ranks

    dev = resolve_device(device)
    per = {}
    for D in ndevs:
        per[D] = run_ranks(
            _rank_report, D, device=dev, n_devices=D, strong_n=strong_n,
            weak_rows=weak_rows_per_dev, b=b, rtol=rtol, reps=reps,
            weak_n=weak_n, weak_rows_apply=weak_rows_apply,
            inner_iters=inner_iters)
    tag = lambda D: {"backend": _label(dev, choose_backend(dev, D)),
                     "ranks_per_card": ranks_per_card(dev, D)}
    strong = [{**per[D]["strong"], **tag(D)} for D in ndevs]
    d0, t0 = strong[0]["n_devices"], strong[0]["solve_s"]
    for rec in strong:
        rec["strong_efficiency"] = (t0 * d0) / (rec["n_devices"]
                                                * rec["solve_s"])
    weak = {}
    for batch in (1, 8):
        series = [{**per[D]["weak"][batch], **tag(D)} for D in ndevs]
        for rec in series:
            rec["weak_efficiency"] = (series[0]["s_per_apply"]
                                      / rec["s_per_apply"])
        weak[batch] = series
    labels = sorted({tag(D)["backend"] for D in ndevs})
    shared = any((tag(D)["ranks_per_card"] or 1) > 1 for D in ndevs)
    return {
        "backend": labels[0] if len(labels) == 1 else labels,
        "devices": list(ndevs),
        "strong": strong,
        "weak_apply_constant_work": weak[1],
        "weak_apply_batched_rhs_b8": weak[8],
        "weak_solve_square_grids": [{**per[D]["weak_solve"], **tag(D)}
                                    for D in ndevs],
        "apply": [{**per[D]["apply"], **tag(D)} for D in ndevs],
        "halo": [{**per[D]["halo"], **tag(D)} for D in ndevs],
        "scaling_numbers": dev.type == "cuda" and not shared,
        "notes": ("cpu-gloo: processes sharing the host's cores, which "
                  "checks the harness and the code path only; cuda-gloo "
                  "with ranks_per_card > 1: ranks taking turns on one card, "
                  "not a scaling measurement; only cuda-nccl (a card per "
                  "rank) times are scaling numbers.  A single right-hand "
                  "side's staged sweep weak-scales as ~1/D by construction "
                  "(the recursion is serial); the batch of eight rides the "
                  "same schedule.  weak_solve_square_grids reports "
                  "solve_s_per_iter to separate the drift of the iteration "
                  "count from scaling."),
    }


def single_chip_anchor(n=1023, b=12, g_dtype="bf16", device="cuda") -> dict:
    """One rank with no process group against the single-card apply: the
    distributed path at D = 1 must cost what the plain path costs."""
    from .. import driver
    from ..dist.partition import dist_state_from_preconditioner, make_mesh
    from ..dist.sweep import dist_apply_preconditioner
    from .roofline import _seconds_per_call, measure_sweep

    dev = resolve_device(device)
    single = measure_sweep(n=n, b=b, g_dtype=g_dtype, device=dev)
    mesh = make_mesh(device=dev)
    driver._set_full_float32()
    cd = driver.default_complex_dtype(dev)
    A, hm, f = driver._assemble_stage(
        (n + 1) / 8.0, 100.0, 2.0, n=n, b=b, problem="c1_f1",
        fidelity="corrected", cdtype=cd, device=dev)
    P = driver._factor_stage(
        A, hm, b=b, hf_full_coupling=True, d2_replace=True, setup_chunk=128,
        g_dtype=g_dtype,
        factor_stride=driver.auto_factor_stride(n, "c1_f1", dev),
        device=dev)
    del hm
    S = dist_state_from_preconditioner(P, mesh)
    del P
    u = f.reshape(n, n)
    dt = _seconds_per_call(lambda: dist_apply_preconditioner(mesh, S, u), 5,
                           dev)
    return {"n": n, "g_dtype": g_dtype,
            "single_chip_s_per_apply": single["s_per_apply"],
            "dist_1dev_s_per_apply": dt,
            "ratio": dt / max(single["s_per_apply"], 1e-12),
            "single_chip_roofline_fraction": single["roofline_fraction"]}


def setup_anchor(n=1023, b=12, g_dtype="bf16", factor_stride=None, reps=3,
                 device="cuda") -> dict:
    """One rank's `distributed_setup` with no process group against the
    single-card assemble and factor stages: D = 1 must cost what the
    plain setup costs."""
    from .. import driver
    from ..dist.factor import distributed_setup
    from ..dist.partition import make_mesh

    dev = resolve_device(device)
    cd = driver.default_complex_dtype(dev)
    if factor_stride is None:
        factor_stride = driver.auto_factor_stride(n, "c1_f1", dev)
    mesh = make_mesh(device=dev)

    def single(wn):
        A, hm, _ = driver._assemble_stage(
            wn, 100.0, 2.0, n=n, b=b, problem="c1_f1",
            fidelity="corrected", cdtype=cd, device=dev)
        driver._factor_stage(A, hm, b=b, hf_full_coupling=True,
                             d2_replace=True, setup_chunk=128,
                             g_dtype=g_dtype, factor_stride=factor_stride,
                             device=dev)

    def dist(wn):
        distributed_setup(mesh, n, b, wn, 100.0, 2.0, "c1_f1",
                          g_dtype=g_dtype, factor_stride=factor_stride,
                          complex_dtype=cd)

    t_single = _timed(mesh, lambda: single(16.1), reps)
    t_dist = _timed(mesh, lambda: dist(16.1), reps)
    return {"n": n, "b": b, "g_dtype": g_dtype,
            "factor_stride": int(factor_stride),
            "single_chip_setup_s": t_single, "dist_1dev_setup_s": t_dist,
            "ratio": t_dist / max(t_single, 1e-12)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--strong-n", type=int, default=64)
    ap.add_argument("--weak-rows", type=int, default=16)
    ap.add_argument("--b", type=int, default=3)
    ap.add_argument("--ndevs", type=int, nargs="+", default=[1, 2, 4, 8])
    ap.add_argument("--anchor", action="store_true",
                    help="also run the one-rank anchors (needs the card)")
    ap.add_argument("--out", default=None)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = ap.parse_args(argv)
    rep = scaling_report(strong_n=args.strong_n,
                         weak_rows_per_dev=args.weak_rows, b=args.b,
                         ndevs=tuple(args.ndevs), device=args.device)
    if args.anchor:
        rep["single_chip_anchor"] = single_chip_anchor(device=args.device)
        rep["setup_anchor"] = setup_anchor(device=args.device)
    js = json.dumps(rep, indent=1)
    print(js)
    if args.out:
        with open(args.out, "w") as fh:
            fh.write(js + "\n")
    return 0
