"""Split a sweep step's time on the card: the grid barrier against the rest.

    python3 -m helmholtz_tpu_torch.scripts.measure_sweep_barrier

Builds `csrc/sweep.cu` four ways into `build/`: as it
is (cooperative_groups' grid.sync() a step), with a generation barrier of
release / acquire atomics in place of the narrow kernel's grid.sync(), with
no grid barrier a step at all (narrow and wide kernel), and with the wide
kernel's products left out.  The last two give WRONG results (their
relative errors are printed): they stand only for the time of a step
without its barrier, and for what a wide step spends besides its FMAs (its
copies, epilogue and barrier).  Each build is timed at n = 1023 over bf16
G in turns, for the sweep variants the full-width paths launch and the wide
kernel at 16 and 64 right-hand sides, and prints one JSON line a variant
and turn, after the card's name and power limit.  Each variant's source is the package's
with its barrier replaced; a replacement whose anchor is not found exactly
once raises, so no variant is the unchanged kernel under another name.
Needs one CUDA device.
"""
import ctypes
import itertools
import json
import subprocess
import sys

import torch

from helmholtz_tpu_torch.ops.kernels import build
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.scripts.common import (card, lerp_tables, random_g,
                                                rel_err, sweep_inputs, time_ms)

#: the full-width paths' grid, the 5-point and the 9-point depth, and the
#: stride of the compressed stacks (`chip_smoke.py` FULL, NINE, LERP_STRIDE)
N, B5, B9, STRIDE = 1023, 12, 74, 7

# A generation barrier: thread 0 of each block adds its arrival to one
# counter; the last to arrive resets it and bumps the generation that the
# others wait on.  Release on arrival, acquire on the wait.
GEN2 = r'''
__device__ unsigned int g_count = 0, g_gen = 0;
__device__ __forceinline__ unsigned int gen_start() {
    unsigned int gen;
    asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];" : "=r"(gen) : "l"(&g_gen) : "memory");
    return gen;
}
__device__ __forceinline__ void gen_barrier2(unsigned int nblocks, unsigned int& my_gen) {
    __syncthreads();
    if (threadIdx.x == 0) {
        unsigned int arrived;
        asm volatile("atom.acq_rel.gpu.global.add.u32 %0, [%1], 1;" : "=r"(arrived) : "l"(&g_count) : "memory");
        if (arrived == nblocks - 1) {
            asm volatile("st.relaxed.gpu.global.u32 [%0], 0;" :: "l"(&g_count) : "memory");
            asm volatile("red.release.gpu.global.add.u32 [%0], 1;" :: "l"(&g_gen) : "memory");
        } else {
            unsigned int g;
            do { asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(g) : "l"(&g_gen) : "memory"); } while (g == my_gen);
        }
        my_gen += 1;
    }
    __syncthreads();
}
'''


def replace_once(text, old, new):
    """text with its one occurrence of `old` replaced; raises unless `old`
    occurs exactly once."""
    if text.count(old) != 1:
        raise ValueError(f"{old!r} occurs {text.count(old)} times in "
                         "csrc/sweep.cu, not once")
    return text.replace(old, new)


def variants():
    """The three sources: as it is, the generation barrier, no barrier."""
    src = (build.CSRC_DIR / "sweep.cu").read_text()
    gen2 = replace_once(src, "// One element of the operand",
                        GEN2 + "\n// One element of the operand")
    gen2 = replace_once(gen2, "cg::grid_group grid = cg::this_grid();",
                        "unsigned int my_gen = threadIdx.x == 0 ? "
                        "gen_start() : 0;")
    gen2 = replace_once(gen2, "grid.sync();",
                        "gen_barrier2(gridDim.x, my_gen);")
    none = replace_once(src, "grid.sync();", "__syncthreads();")
    none = replace_once(none, "if (next) all_blocks.sync();",
                        "if (next) __syncthreads();")
    no_product = replace_once(src, "            wide_tile_product<T, TR>(",
                              "            if (false) wide_tile_product<T, TR>(")
    return {"grid_sync": src, "generation": gen2, "none": none,
            "no_product": no_product}


def build_all():
    """Compile the variants in parallel; returns their libraries, with the
    hh_sweep and hh_sweep_wide entries typed."""
    build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name, text in variants().items():
        cu = build.BUILD_DIR / f"sweep_barrier_{name}.cu"
        cu.write_text(text)
        so = cu.with_suffix(".so")
        procs[name] = (so, subprocess.Popen(
            [build._find_nvcc(), *build.NVCC_FLAGS, "-shared", "-o",
             str(so), str(cu)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    fns = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {name}:\n{out}")
        lib = ctypes.CDLL(str(so))
        for entry in ("hh_sweep", "hh_sweep_wide"):
            getattr(lib, entry).argtypes = build._SIGNATURES[entry]
            getattr(lib, entry).restype = ctypes.c_int
        fns[name] = lib
    return fns


def main():
    if not torch.cuda.is_available():
        print("measure_sweep_barrier needs a CUDA device", file=sys.stderr)
        sys.exit(1)
    print(json.dumps({"card": card()}), flush=True)
    fns = build_all()
    dev = torch.device("cuda")
    gen = torch.Generator(device=dev)
    gen.manual_seed(0)
    n = N
    G16 = [g.to(torch.bfloat16) for g in random_g(n - B5, n, gen, dev)]
    tables = lerp_tables(n - B9, STRIDE, dev)
    S16 = [g[:int(tables[0].max()) + 2].contiguous() for g in G16]
    sms = torch.cuda.get_device_properties(dev).multi_processor_count

    def run(fn, planes, mode, R, tri, lerp):
        ld = planes[0].shape[-1]
        S = (tables[0].shape[0] if lerp else planes[0].shape[0]) \
            - (1 if mode == "fwd" else 0)
        u, c, carry0 = sweep_inputs(n, S, R, gen, dev, tri)
        width = R or 1
        out = torch.empty_like(u)
        scratch = torch.empty((2, width, n), dtype=u.dtype, device=dev)
        plan = k2.launch_plan(n, width, 2, lerp, False, sms)
        args = (k2.MODES.index(mode), 1, planes[0].data_ptr(),
                planes[1].data_ptr(), n * ld, ld, n, S, width, width * n,
                tables[0].data_ptr() if lerp else None,
                tables[1].data_ptr() if lerp else None, u.data_ptr(),
                c.data_ptr(), int(tri), carry0.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), plan.blocks, plan.rows_per_block,
                plan.stages, torch.cuda.current_stream().cuda_stream)
        ms = time_ms(lambda: build.check(fn.hh_sweep(*args),
                                         "sweep variant"), 5)
        kw = dict(g_lo=tables[0], g_w=tables[1]) if lerp else {}
        _, rel = rel_err(out, k2.plain_sweep(*planes, u, c, carry0,
                                                 mode=mode, **kw))
        return ms, S, rel

    # (mode, R, tri, lerp): the variants of the full-width paths
    cases = [("fwd", None, False, False), ("bwd", None, False, False),
             ("fwd", 4, False, False), ("bwd", 4, False, False),
             ("fwd", None, True, False), ("bwd", None, True, False),
             ("fwd", 4, True, True), ("bwd", 4, False, True)]
    def run_wide(fn, mode, R):
        ld = G16[0].shape[-1]
        S = G16[0].shape[0] - (1 if mode == "fwd" else 0)
        u, c, carry0 = sweep_inputs(n, S, R, gen, dev)
        out = torch.empty_like(u)
        scratch = torch.zeros((2, R, ld), dtype=u.dtype, device=dev)
        plan = k2.wide_plan(n, R, 2, sms)
        args = (k2.MODES.index(mode), 1, G16[0].data_ptr(),
                G16[1].data_ptr(), n * ld, ld, n, S, R, R * n, u.data_ptr(),
                c.data_ptr(), carry0.data_ptr(), out.data_ptr(),
                scratch.data_ptr(), plan.row_groups, plan.rows_per_block,
                plan.slices, plan.stages,
                torch.cuda.current_stream().cuda_stream)
        ms = time_ms(lambda: build.check(fn.hh_sweep_wide(*args),
                                         "wide sweep variant"), 5)
        _, rel = rel_err(out, k2.plain_sweep(*G16, u, c, carry0, mode=mode))
        return ms, S, rel

    for turn in range(2):
        order = list(fns.items())
        for name, fn in (order if turn == 0 else order[::-1]):
            for mode, R, tri, lerp in cases:
                if name == "no_product":
                    continue       # the narrow kernel is as it is there
                ms, S, rel = run(fn, S16 if lerp else G16, mode, R, tri, lerp)
                print(json.dumps({"turn": turn, "barrier": name,
                                  "mode": mode, "R": R, "tri": tri,
                                  "lerp": lerp, "ms": ms,
                                  "step_us": ms / S * 1e3, "rel_err": rel}),
                      flush=True)
            for mode, R in itertools.product(("fwd", "bwd"), (16, 64)):
                if name == "generation":
                    continue       # the wide kernel is as it is there
                ms, S, rel = run_wide(fn, mode, R)
                print(json.dumps({"turn": turn, "barrier": name,
                                  "kernel": "wide", "mode": mode, "R": R,
                                  "ms": ms, "step_us": ms / S * 1e3,
                                  "rel_err": rel}), flush=True)


if __name__ == "__main__":
    main()
