"""Times the block-sparse kernel K4 against the library at the twelve shapes
`chip_smoke.py` times, for the package of a given tree.

    python3 helmholtz_tpu_torch/scripts/measure_bsr.py [--root DIR]
        [--label NAME] [--reps 10]

Imports `helmholtz_tpu_torch` from DIR (default: the checkout that holds
this script), so that one script times two trees of the package, such as a
commit and its parent unpacked with `git archive`: run it once a tree, in
turns (parent, change, change, parent), in one call on one card.  The
inputs, timers and bounds are this checkout's (`common.py` beside it and
`bench/timing.py`, loaded by path), so both trees see the same data; K4 is
reached through what every slice of the port has,
`ops.kernels.bsr_spmm.bsr_matmat`.

The shapes: the exact path's n = 511 operator as BSR (1,531 blocks of 511
x 511) at K = 1, 4 and 16, and random 16 x 12 block matrices (about 40%
stored, block row 3 empty) at 64 x 64, 128 x 128 and 48 x 80 blocks and
K = 16, 5 and 1.  For each it holds K4 against `plain_bsr_matmat` within
K4_TOL, checks that two calls give equal bits, and prints one JSON line:
the call's time (`call_ms`: CUDA events around the Python call after an
L2 flush, as `chip_smoke.py` times it), the device's work alone
(`device_ms`, `bench/timing.py`), the host's cost of one call
(`host_ms`), the same three for the library call (torch sparse CSR of the
stored entries @ X), and the bound: against the card's published peaks
(`bound_ms`), and against the peaks this run measures where DIR's package
has `bench.roofline` (`bound_measured_ms`, null otherwise).  The first
line gives the card's name and power limit.  Needs one CUDA device;
builds DIR's kernels unless built.
"""
import argparse
import importlib.util
import json
import math
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
K4_TOL = 5e-6       # chip_smoke.py's tolerance for K4
EXACT = dict(n=511, b=12, wave_num=64.0, const=81.0, problem="c1_f1")


def say(what, **fields):
    print(json.dumps({"measure": what, **fields}), flush=True)


def _load(name, path):
    """The module at `path`, loaded by path whatever tree is on sys.path."""
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def main():
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--root", default=os.path.dirname(os.path.dirname(
        HERE)), help="tree whose package is timed")
    parser.add_argument("--label", default=None)
    parser.add_argument("--reps", type=int, default=10)
    args = parser.parse_args()
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch

    if not torch.cuda.is_available():
        print("measure_bsr: needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    import helmholtz_tpu_torch as ht
    from helmholtz_tpu_torch.ops.kernels import build
    from helmholtz_tpu_torch.ops.kernels import bsr_spmm as k4
    from helmholtz_tpu_torch.ops.sparse_algebra import stencil_to_bsr

    common = _load("measure_bsr_common", os.path.join(HERE, "common.py"))
    timing = _load("measure_bsr_timing",
                   os.path.join(os.path.dirname(HERE), "bench", "timing.py"))

    label = args.label or root
    say("card", label=label, nvidia_smi=common.card(),
        package=os.path.dirname(ht.__file__), torch=torch.__version__)
    t0 = time.perf_counter()
    build.library()
    say("build", label=label, seconds=time.perf_counter() - t0)

    dev = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        from helmholtz_tpu_torch.bench import roofline
    except ImportError:         # a tree from before the measured peaks
        roofline = None
    peaks = None
    if roofline is not None:
        peaks = {"read_gb_per_s": roofline.measure_read_bw(),
                 "streaming_gb_per_s": roofline.measure_streaming_bw(),
                 "f32_matmul_tflop_per_s": roofline.measure_matmul_tflops()}
    say("peaks", label=label, measured=peaks,
        published={"gb_per_s": timing.PUBLISHED_BYTES_PER_S / 1e9,
                   "f32_tflop_per_s": timing.PUBLISHED_F32_FLOPS / 1e12})

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device=dev)
    reps = args.reps

    def one(name, A, K, csr):
        X = common.randc((A.shape[1], K), gen, dev)
        got = k4.bsr_matmat(A, X)
        again = k4.bsr_matmat(A, X)
        ref = k4.plain_bsr_matmat(A, X)
        err, rel = common.rel_err(got, ref)
        bits_equal = bool(torch.equal(got, again))
        call = lambda: k4.bsr_matmat(A, X)        # noqa: E731
        lib = lambda: csr @ X                     # noqa: E731
        _, lib_rel = common.rel_err(lib(), ref)
        nbytes, flops = common.bsr_work(A, K)
        bound, by = common.bound_ms(nbytes, flops,
                                    timing.PUBLISHED_BYTES_PER_S,
                                    timing.PUBLISHED_F32_FLOPS)
        rec = dict(
            label=label, name=name, nblocks=A.data.shape[0],
            blocksize=list(A.blocksize), K=K, max_abs_err=err, rel_err=rel,
            tol=K4_TOL, bits_equal=bits_equal,
            call_ms=common.time_ms(call, reps, flush),
            device_ms=timing.device_ms(call, reps, flush),
            host_ms=common.host_ms(call, 2 * reps),
            library_rel_err=lib_rel,
            library_call_ms=common.time_ms(lib, reps, flush),
            library_device_ms=timing.device_ms(lib, reps, flush),
            library_host_ms=common.host_ms(lib, 2 * reps),
            bound_ms=bound, bound_by=by, bound_measured_ms=None)
        if peaks:
            rec["bound_measured_ms"], _ = common.bound_ms(
                nbytes, flops, peaks["read_gb_per_s"] * 1e9,
                peaks["f32_matmul_tflop_per_s"] * 1e12)
        say("bsr_matmat", **rec)
        return math.isfinite(rel) and rel <= K4_TOL and bits_equal

    ok = True
    cfg = ht.HelmholtzConfig(n=EXACT["n"], b=EXACT["b"],
                             wave_num=EXACT["wave_num"], const=EXACT["const"])
    A = stencil_to_bsr(ht.assemble_problem(cfg, EXACT["problem"]).A)
    csr = common.bsr_as_csr(A)
    for K in (1, 4, 16):
        ok &= one("n511_operator", A, K, csr)
    del A, csr
    torch.cuda.empty_cache()
    for (bm, bn), K in common.K4_RANDOM:
        A = common.random_bsr(16, 12, bm, bn, gen, dev)
        ok &= one("random", A, K, common.bsr_as_csr(A))
    say("done", label=label, ok=bool(ok))
    if not ok:
        sys.exit(1)


if __name__ == "__main__":
    main()
