"""The benchmark of helmholtz_tpu_torch on one NVIDIA H100.

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

run from the root of a checkout.  The cell is an entry of `workloads` in
`BENCHMARK.json`; its configuration is `portbench/configs/<config>.json`,
its traffic mix `portbench/traffic/<traffic>.json`, its limits
`portbench/limits/<cell>.json`, and each metric it reports
`portbench/metrics/<name>.py`.  With `--trace 0` the run prints the cell's
end-to-end metrics, with `--trace 1` its per-layer metrics, as the last
line of standard output: one JSON object.  The numbers the check compared,
each beside its limit, are the last lines of standard error.

Refuses to run (exit 2, no result) without a card, with fewer cards than
the cell asks for, or where JAX or the JAX package was loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

HERE = pathlib.Path(__file__).resolve().parent
ROOT = HERE.parent
CACHE = ROOT / ".portbench_cache"


def say(*parts):
    print(*parts, file=sys.stderr, flush=True)


def refuse(msg: str) -> None:
    say(f"portbench: {msg}")
    sys.exit(2)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    # every build and kernel cache at a fixed path inside the checkout (the
    # program's own kernel library builds into helmholtz_tpu_torch/build/)
    os.environ["TORCH_EXTENSIONS_DIR"] = str(CACHE / "torch_extensions")
    os.environ["TRITON_CACHE_DIR"] = str(CACHE / "triton")
    os.environ["CUDA_CACHE_PATH"] = str(CACHE / "cuda")
    os.environ["USE_FLAX"] = "0"
    sys.path[:0] = [str(HERE), str(ROOT)]

    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if args.workload not in cells:
        refuse(f"no workload {args.workload!r} in BENCHMARK.json")
    cell = cells[args.workload]
    configs = {c["name"]: c for c in bench["configs"]}
    cfg = json.loads((ROOT / configs[cell["config"]]["file"]).read_text())

    import torch
    if not torch.cuda.is_available():
        refuse("torch.cuda.is_available() is false: this benchmark "
               "measures the card and has no CPU path")
    if torch.cuda.device_count() < int(cell["chips"]):
        refuse(f"the cell asks for {cell['chips']} cards, "
               f"{torch.cuda.device_count()} present")

    import check
    import harness
    import traffic

    group = "per_layer" if args.trace else "end_to_end"
    metric_defs = [m for m in bench[group]
                   if args.workload in m.get("workloads", [args.workload])]
    result = harness.run_cell(
        cell, cfg, traffic.load(cell["traffic"]),
        check.load_limits(args.workload), seed=args.seed,
        seconds=args.seconds, trace=bool(args.trace),
        metric_defs=metric_defs, device="cuda", t_start=T_START)

    found = harness.forbidden_modules()
    if found:
        refuse(f"modules loaded that this benchmark may not load: {found}")
    try:
        limit = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30).stdout.strip().splitlines()
    except (OSError, subprocess.SubprocessError):
        limit = []
    result["device"]["power_limit"] = limit[0] if limit else None
    result["check"] = result.pop("check")      # the compared numbers last
    say(f"portbench: {args.workload} seed {args.seed}: "
        f"{result['requests']} requests, {result['attempted']} right-hand "
        f"sides, {result['checked_rhs']} checked; launches "
        f"{json.dumps(result['launches'])}")
    if result["setup_build_s"]:
        say(f"portbench: this run built the kernel library, "
            f"{result['setup_build_s']:.1f} s of its setup_s")
    for name, v in result["check"].items():
        say(f"check {name}: {v['value']!r} limit {v['limit']!r}")
    print(json.dumps(result), flush=True)


if __name__ == "__main__":
    main()
