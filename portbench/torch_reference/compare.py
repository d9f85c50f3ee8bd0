"""The port's compressed preconditioner apply against the plain PyTorch
reference (`sweeping_torch.py`), at a configuration's full size on the card.

    python3 portbench/torch_reference/compare.py --seed <n> [--rhs 16] \
        [--out FILE] [--n 63 --device cpu]

For bf16 and f32 G storage the port factors the configuration's operator at
the top of its band (omega / 2 pi = (n + 1) / 8) through its own stages,
in complex64 at the configuration's stride over a compressed stack, and
applies the preconditioner once to `--rhs` seeded random right-hand sides
(`SweepingPreconditioner.apply_multi`, the sweep kernel on the card).  The
reference factors the same operator in complex128, CHUNK subgrids at a
time, and applies its preconditioner to the same right-hand sides with its
corner inverses as computed ("exact") and stored in each type
(`sweeping_torch.stored`).  Prints one JSON line with, for each type, each
right-hand side's relative error ||port - reference|| / ||reference||
against the reference stored in the same type (`same`, held to
`TOLERANCE`) and against the exact one (`exact`), and the storage's own
error, the reference stored in the type against the exact one (`floor`);
and the control: the reference stored in float8 (e4m3), the type below
bfloat16, against the reference stored in bfloat16, which must exceed
bfloat16's tolerance.
"""
import argparse
import importlib.util
import json
import math
import pathlib
import subprocess
import sys
import time

import torch

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent.parent

#: the largest relative error of one apply against the reference with G
#: stored in the same type.  float32: the port's complex64 factor and
#: sweeps (2e-6 to 2e-5 at n = 63 to 511 on the CPU, about as n^1.4;
#: 1.6e-4 at n = 2047 on the card).  bfloat16: that, and the elements whose
#: rounding the complex64 factor tips over (1e-6 to 1e-4 at n = 63 to 255),
#: at most a tenth of what bfloat16 storage itself does to the apply (the
#: floor: 0.9e-2 to 1.3e-2 at n = 63 to 255)
TOLERANCE = {"f32": 1e-3, "bf16": 1e-2}
CONFIG = "c1_f1-n2047"
CHUNK = 16
G_DTYPES = {"f32": torch.float32, "bf16": torch.bfloat16,
            "e4m3": torch.float8_e4m3fn}


def load_reference():
    spec = importlib.util.spec_from_file_location(
        "sweeping_torch", HERE / "sweeping_torch.py")
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def random_rhs(k: int, n: int, seed: int, device):
    g = torch.Generator(device="cpu").manual_seed(seed)
    shape = (k, n * n)
    return torch.complex(torch.randn(shape, generator=g, dtype=torch.float64),
                         torch.randn(shape, generator=g,
                                     dtype=torch.float64)).to(device)


def rel_err(Y, Y_ref) -> list:
    return ((Y - Y_ref).norm(dim=1) / Y_ref.norm(dim=1)).tolist()


def port_apply(cfg: dict, wave_num: float, X, g_dtype, device):
    """(Y, seconds of the factor, seconds of the apply): the port's stages
    as the benchmark's entry calls them, at complex64."""
    from helmholtz_tpu_torch.fd import problems as fd_problems
    from helmholtz_tpu_torch.fd import stencil as fd_stencil
    from helmholtz_tpu_torch.precond.sweeping import setup_preconditioner

    n, b, const = int(cfg["n"]), int(cfg["b"]), float(cfg["const"])
    cd = torch.complex64
    omega = complex(2.0 * math.pi * wave_num, float(cfg["alpha"]))
    h = 1.0 / (n + 1)
    c_full, _ = fd_problems.PROBLEMS[cfg["problem"]](
        omega, n, complex_dtype=cd, device=device)
    A = fd_stencil.build_a_stencil(n, b, const, b * h, omega, h, c_full,
                                   fidelity=cfg["fidelity"], complex_dtype=cd)
    hm = fd_stencil.build_hm_stencils(n, b, const, b * h, omega, h, c_full,
                                      fidelity=cfg["fidelity"],
                                      complex_dtype=cd)
    sync = lambda: torch.cuda.synchronize() if X.is_cuda else None
    sync()
    t0 = time.perf_counter()
    P = setup_preconditioner(A, hm, b, g_dtype=g_dtype,
                             factor_stride=int(cfg["factor_stride"]),
                             g_compress=True, device=device)
    sync()
    t1 = time.perf_counter()
    Y = P.apply_multi(X.to(cd))
    sync()
    t2 = time.perf_counter()
    return Y.to(torch.complex128), t1 - t0, t2 - t1


def main():
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--rhs", type=int, default=16)
    ap.add_argument("--n", type=int, help="a smaller grid, to rehearse")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--out")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{CONFIG}.json").read_text())
    if args.n:
        cfg["n"] = args.n
    torch.backends.cuda.matmul.allow_tf32 = False
    ref = load_reference()
    n, b = int(cfg["n"]), int(cfg["b"])
    wave_num = (n + 1) / 8
    dev = torch.device(args.device)
    X = random_rhs(args.rhs, n, args.seed, dev)
    sync = lambda: torch.cuda.synchronize() if dev.type == "cuda" else None

    t0 = time.perf_counter()
    R = ref.factor(n, b, float(cfg["const"]),
                   ref.omega_of(wave_num, float(cfg["alpha"])), cfg["medium"],
                   stride=int(cfg["factor_stride"]), chunk=CHUNK,
                   device=dev)
    sync()
    t1 = time.perf_counter()

    def ref_apply(P):
        return P.apply(X.reshape(-1, n, n)).reshape(args.rhs, n * n)

    Y = ref_apply(R)
    sync()
    out = {"config": CONFIG, "n": n, "wave_num": wave_num,
           "rhs": args.rhs, "seed": args.seed,
           "stride": int(cfg["factor_stride"]),
           "reference_factor_s": t1 - t0,
           "reference_apply_s": time.perf_counter() - t1,
           "samples": len(R.steps)}
    Ys = {name: ref_apply(ref.stored(R, dtype))
          for name, dtype in G_DTYPES.items()}
    del R
    control = max(rel_err(Ys["e4m3"], Ys["bf16"]))
    out["control_e4m3_vs_bf16"] = {
        "worst": control, "tolerance": TOLERANCE["bf16"],
        "not_correct": control > TOLERANCE["bf16"]}
    if dev.type == "cuda":
        torch.cuda.empty_cache()
        out["device"] = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True,
            text=True).stdout.strip()
    for name in TOLERANCE:
        Yp, f_s, a_s = port_apply(cfg, wave_num, X, G_DTYPES[name], dev)
        same = rel_err(Yp, Ys[name])
        out[name] = {"same": same, "worst": max(same),
                     "tolerance": TOLERANCE[name],
                     "ok": max(same) <= TOLERANCE[name],
                     "exact": rel_err(Yp, Y),
                     "floor": max(rel_err(Ys[name], Y)),
                     "port_factor_s": f_s, "port_apply_s": a_s}
        del Yp
        if dev.type == "cuda":
            out[name]["peak_gib"] = torch.cuda.max_memory_allocated() / 2 ** 30
            torch.cuda.empty_cache()
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as f:
            f.write(line + "\n")
    sys.exit(0 if all(out[k]["ok"] for k in TOLERANCE)
             and out["control_e4m3_vs_bf16"]["not_correct"] else 1)


if __name__ == "__main__":
    main()
