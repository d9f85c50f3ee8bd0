"""Where the time of the full-width 9-point solve goes.

    python3 -m helmholtz_tpu_torch.scripts.measure_solve9 [--n 1023 --b 74]

Times, on one CUDA device, the parts of
`run_solver(n, b, n/8, 60, stencil="9pt", g_dtype="bf16", factor_stride=7)`:
the setup split into assembly of the operator, assembly of the sampled
subgrid family, the tridiagonal Schur recursion of the samples (and the
batched inverses inside it), the lerp expansion and the H_F stack; and one
preconditioner apply split into its two sweeps, its two block-Thomas solves
and the rest, beside one 9-point operator product.  One JSON line per part
after a line with the card's name and power limit.  Device times by CUDA
events after a warm-up; the setup parts by a host clock around work that
ends in a synchronize.
"""
import argparse
import json
import subprocess
import sys
import time

import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch import driver
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops import dense
from helmholtz_tpu_torch.ops import spmv
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.precond import sweeping, sweeping9


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def event_ms(fn, reps=5):
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def say(part, **fields):
    print(json.dumps({"part": part, **fields}), flush=True)


@torch.no_grad()
def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--n", type=int, default=1023)
    parser.add_argument("--b", type=int, default=74)
    parser.add_argument("--stride", type=int, default=7)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        print("measure_solve9 needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    n, b, stride = args.n, args.b, args.stride
    say("card", card=smi, n=n, b=b, stride=stride)
    cfg = ht.HelmholtzConfig(n=n, b=b, wave_num=n / 8.0, const=60.0)
    gamma = 2.0 / 3.0
    dev = torch.device("cuda")
    cd = torch.complex64
    dense.batched_inverse(torch.eye(8, dtype=cd, device=dev)[None])  # warm up

    # -- setup ----------------------------------------------------------------
    (A9, c_full, f_grid), t = timed(lambda: driver._assemble_a9_stage(
        cfg.wave_num, cfg.const, 2.0, gamma, n=n, b=b, problem="c1_f1",
        fidelity="corrected", cdtype=cd, device=dev))
    say("assemble_operator", seconds=t)
    M = n - b
    pos = sweeping.sample_positions(M, stride)
    rows = b + torch.as_tensor(pos, device=dev)
    hm, t = timed(lambda: fd_stencil.build_hm_stencils9(
        n, b, cfg.const, cfg.eta, cfg.omega, cfg.h, c_full, gamma=gamma,
        fidelity="corrected", complex_dtype=cd, rows=rows))
    say("assemble_samples", seconds=t, samples=len(pos),
        family_bytes=9 * hm.cc.numel() * 8)

    # the recursion with its inverses timed apart from its shifted passes
    inv_seconds = [0.0]
    plain_inverse = sweeping9.batched_inverse

    def clocked_inverse(X):
        out, t = timed(lambda: plain_inverse(X))
        inv_seconds[0] += t
        return out

    sweeping9.batched_inverse = clocked_inverse
    try:
        T, t = timed(lambda: sweeping9._schur_corner_inverse9(hm))
    finally:
        sweeping9.batched_inverse = plain_inverse
    say("schur_recursion_samples", seconds=t, inverses=len(pos) * b,
        inverse_seconds=inv_seconds[0],
        ms_per_inverse=inv_seconds[0] / (len(pos) * b) * 1e3,
        shifted_pass_seconds=t - inv_seconds[0])
    del hm
    ld = k2.g_ld(n)
    Ts_re = torch.zeros((len(pos), n, ld), device=dev)
    Ts_im = torch.zeros_like(Ts_re)
    Ts_re[:, :, :n], Ts_im[:, :, :n] = T.real, T.imag
    del T
    (G_re, G_im), t = timed(lambda: sweeping.expand_strided_samples(
        Ts_re, Ts_im, M=M, stride=stride, g_dtype=torch.bfloat16))
    say("expand_samples", seconds=t, g_bytes=2 * G_re.numel() * 2)
    del Ts_re, Ts_im
    P, t = timed(lambda: sweeping9._with_hf9(A9, b, G_re, G_im,
                                             d2_replace=True))
    say("factor_hf", seconds=t, inverses=b, tf_bytes=P.TF.numel() * 8)

    # -- one apply --------------------------------------------------------------
    f9 = driver._mass_filter9_stage(f_grid.to(cd), cfg.wave_num, cfg.const,
                                    2.0, n=n, b=b)
    F = f9[None]
    apply_ms = event_ms(lambda: sweeping9.apply_preconditioner9_multi(P, F))
    u = F.transpose(0, 1).contiguous()
    zero = torch.zeros_like(u[-1])
    a_u_top0 = torch.cat([P.a_u[b:-1], torch.zeros_like(P.a_u[-1:])], dim=0)
    fwd_ms = event_ms(lambda: k2.sweep(
        P.G_re, P.G_im, u[b + 1:], P.a_l[b + 1:], u[b], mode="fwd"))
    bwd_ms = event_ms(lambda: k2.sweep(
        P.G_re, P.G_im, u[b:], a_u_top0, zero, mode="bwd"))
    thomas_ms = event_ms(lambda: sweeping9._block_thomas_solve9(
        P.TF, P.hf_l, P.hf_u, F[:, :b]))
    say("apply", ms=apply_ms, sweep_fwd_ms=fwd_ms, sweep_bwd_ms=bwd_ms,
        thomas_solve_ms=thomas_ms, thomas_solves=2,
        rest_ms=apply_ms - fwd_ms - bwd_ms - 2 * thomas_ms)
    x = f9.reshape(-1)
    say("stencil9_matvec", ms=event_ms(
        lambda: spmv.stencil9_matvec_flat(A9, x), reps=20))


if __name__ == "__main__":
    main()
