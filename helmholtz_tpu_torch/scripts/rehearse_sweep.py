"""Rehearse the sweep kernel (`csrc/sweep.cu`, K2) on the host CPU.

    python3 -m helmholtz_tpu_torch.scripts.rehearse_sweep [--stages 0 1 2]

A cooperative launch hangs the card when any block skips a grid-wide
barrier that another reaches, and a chip call that hangs is expensive.
This script compiles the kernel's own source with `g++ -std=c++20` against
a stub header that maps the CUDA names it uses to host threads:
`threadIdx` / `blockIdx` become thread-locals, `__syncthreads` a barrier of
the block's threads, `grid.sync()` a barrier of the whole grid, the warp
shuffles an exchange through a barrier of the warp's 32 threads, `cp.async`
a 16-byte `memcpy` (its commit and wait are no-ops), `__ldg` / `__ldcg`
plain loads; the one launch runs one `std::thread` per CUDA thread.  It
then calls the C entry point `hh_sweep` through the same `ctypes`
signature as the wrapper, on host tensors, with the launch plan forced to
0, 1 or 2 stages of G in shared memory and to a few blocks, and holds every
result against `ops.kernels.sweep.plain_sweep`: dense, shared and
sample-compressed G, float32 and bfloat16, diagonal and tridiagonal
coupling, every mode, one and three right-hand sides, at n = 17 and 33.
The same indexing and barrier counts as on the card run; the arithmetic is
the host's float32 (the sums' order is the kernel's).  A missed barrier
shows as a hang here (the script's own time limit ends it) instead of on
the card.  Needs g++ and no card; the build goes into
`helmholtz_tpu_torch/build/rehearsal/` (git-ignored).
"""
from __future__ import annotations

import argparse
import ctypes
import itertools
import math
import pathlib
import re
import subprocess
import sys

import torch

from ..ops.kernels import sweep as k2
from ..precond import sweeping

SOURCE = pathlib.Path(__file__).resolve().parents[1] / "csrc" / "sweep.cu"
OUT_DIR = pathlib.Path(__file__).resolve().parents[1] / "build" / "rehearsal"
TOL = 5e-6        # chip_smoke.K2_TOL: the same sums in the same order

STUB = r"""
#pragma once
#include <algorithm>
#include <barrier>
#include <cmath>
#include <cstddef>
#include <cstdint>
#include <cstring>
#include <memory>
#include <thread>
#include <vector>

#define __global__
#define __device__
#define __host__
#define __forceinline__ inline
#define __launch_bounds__(x)
#define __align__(x) alignas(x)

struct dim3 {
    unsigned x = 1, y = 1, z = 1;
    dim3() = default;
    dim3(unsigned a, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
struct float2 { float x, y; };
struct alignas(16) float4 { float x, y, z, w; };
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct __nv_bfloat16 { std::uint16_t bits; };
inline float2 make_float2(float a, float b) { return {a, b}; }
inline float __uint_as_float(unsigned u) {
    float f;
    std::memcpy(&f, &u, 4);
    return f;
}
using std::min;
using std::max;

namespace hh {
struct Warp {
    std::barrier<> bar{32};
    float slot[32];
};
struct Block {
    explicit Block(int threads, std::size_t smem)
        : bar(threads), warps(threads / 32),
          shared((smem + 15) / 16 + 1) {}
    std::barrier<> bar;
    std::vector<Warp> warps;
    std::vector<float4> shared;
};
inline thread_local dim3 tid, bid, bdim, gdim;
inline thread_local Block* block = nullptr;
inline thread_local std::barrier<>* grid_bar = nullptr;
inline int sm_count = 132;

inline float exchange(float v, int from) {
    Warp& w = block->warps[tid.x / 32];
    const int lane = tid.x & 31;
    w.slot[lane] = v;
    w.bar.arrive_and_wait();
    const float r = w.slot[from];
    w.bar.arrive_and_wait();
    return r;
}
}  // namespace hh

#define threadIdx (hh::tid)
#define blockIdx (hh::bid)
#define blockDim (hh::bdim)
#define gridDim (hh::gdim)

inline void __syncthreads() { hh::block->bar.arrive_and_wait(); }
inline float __shfl_xor_sync(unsigned, float v, int off) {
    return hh::exchange(v, (threadIdx.x & 31) ^ off);
}
inline float __shfl_up_sync(unsigned, float v, int d) {
    const int lane = threadIdx.x & 31;
    return hh::exchange(v, lane >= d ? lane - d : lane);
}
inline float __shfl_down_sync(unsigned, float v, int d) {
    const int lane = threadIdx.x & 31;
    return hh::exchange(v, lane + d < 32 ? lane + d : lane);
}
template <typename T> inline T __ldg(const T* p) { return *p; }
template <typename T> inline T __ldcg(const T* p) { return *p; }

namespace cooperative_groups {
struct grid_group {
    void sync() { hh::grid_bar->arrive_and_wait(); }
};
inline grid_group this_grid() { return {}; }
}  // namespace cooperative_groups

using cudaError_t = int;
using cudaStream_t = void*;
constexpr int cudaSuccess = 0;
constexpr int cudaErrorInvalidValue = 1;
constexpr int cudaErrorCooperativeLaunchTooLarge = 720;
constexpr int cudaFuncAttributeMaxDynamicSharedMemorySize = 8;
constexpr int cudaDevAttrMultiProcessorCount = 16;
inline cudaError_t cudaGetDevice(int* d) { *d = 0; return cudaSuccess; }
template <typename K>
inline cudaError_t cudaFuncSetAttribute(K, int, int) { return cudaSuccess; }
inline cudaError_t cudaDeviceGetAttribute(int* v, int, int) {
    *v = hh::sm_count;
    return cudaSuccess;
}
template <typename K>
inline cudaError_t cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        int* n, K, int, std::size_t) {
    *n = 1;
    return cudaSuccess;
}
inline cudaError_t cudaGetLastError() { return cudaSuccess; }

namespace hh {
// One cooperative launch: grid.x blocks of block.x threads, one host
// thread each, every one of them running kernel(arg).
template <typename K, typename A>
cudaError_t launch(K kernel, dim3 grid, dim3 blk, const A& arg,
                   std::size_t smem) {
    const int threads = grid.x * blk.x;
    std::barrier<> gbar(threads);
    std::vector<std::unique_ptr<Block>> blocks;
    for (unsigned b = 0; b < grid.x; ++b)
        blocks.push_back(std::make_unique<Block>(blk.x, smem));
    std::vector<std::thread> pool;
    pool.reserve(threads);
    for (unsigned b = 0; b < grid.x; ++b) {
        for (unsigned t = 0; t < blk.x; ++t) {
            pool.emplace_back([&, b, t] {
                tid = dim3(t);
                bid = dim3(b);
                bdim = blk;
                gdim = grid;
                block = blocks[b].get();
                grid_bar = &gbar;
                kernel(arg);
            });
        }
    }
    for (auto& th : pool) th.join();
    return cudaSuccess;
}
}  // namespace hh

extern "C" void hh_rehearsal_set_sms(int sms) { hh::sm_count = sms; }
"""


def _translate(src: str) -> str:
    """The kernel source with its CUDA-only constructs swapped for the stub's
    host versions; raises if an anchor is not found exactly once."""
    edits = [
        (r"#include <cooperative_groups\.h>\n#include <cuda_bf16\.h>\n"
         r"#include <cuda_runtime\.h>\n", '#include "stub.h"\n'),
        (r"extern __shared__ __align__\(16\) float smem\[\];",
         "float* smem = reinterpret_cast<float*>("
         "hh::block->shared.data());"),
        (r"const unsigned int s =\s*static_cast<unsigned int>\("
         r"__cvta_generic_to_shared\(smem\)\);\s*asm volatile\("
         r"\"cp\.async\.cg\.shared\.global \[%0\], \[%1\], 16;\\n\"\s*"
         r"::\s*\"r\"\(s\), \"l\"\(gmem\) : \"memory\"\);",
         "std::memcpy(smem, gmem, 16);"),
        (r"asm volatile\(\"cp\.async\.commit_group;\\n\" ::: \"memory\"\);",
         ""),
        (r"asm volatile\(\"cp\.async\.wait_group %0;\\n\" :: \"n\"\(N\) : "
         r"\"memory\"\);", ""),
        (r"e = cudaLaunchCooperativeKernel\(reinterpret_cast<const void\*>"
         r"\(kernel\),\s*dim3\(blocks\), dim3\(threads\), params, smem,\s*"
         r"stream\);",
         "(void)params; e = hh::launch(kernel, dim3(blocks), "
         "dim3(threads), args, smem);"),
    ]
    for pattern, new in edits:
        src, count = re.subn(pattern, lambda _m, new=new: new, src)
        if count != 1:
            raise RuntimeError(f"rehearsal edit not applied exactly once "
                               f"({count}): {pattern[:60]!r}")
    return src


def build() -> ctypes.CDLL:
    OUT_DIR.mkdir(parents=True, exist_ok=True)
    (OUT_DIR / "stub.h").write_text(STUB)
    cpp = OUT_DIR / "sweep_host.cpp"
    cpp.write_text(_translate(SOURCE.read_text()))
    lib = OUT_DIR / "libsweep_host.so"
    subprocess.run(["g++", "-std=c++20", "-O1", "-fPIC", "-shared",
                    "-pthread", "-fno-strict-aliasing", "-Wno-unknown-pragmas",
                    "-o", str(lib),
                    str(cpp)], check=True)
    so = ctypes.CDLL(str(lib))
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    so.hh_sweep.argtypes = [i, i, p, p, ll, i, i, i, i, ll, p, p, p, p, i,
                            p, p, p, i, i, i, p]
    so.hh_sweep.restype = i
    so.hh_rehearsal_set_sms.argtypes = [i]
    return so


def _inputs(n, S, R, tri, gen):
    def randc(shape):
        re = torch.randn(shape, generator=gen)
        im = torch.randn(shape, generator=gen)
        return torch.complex(re, im) / math.sqrt(2.0)

    shape = (S, n) if R is None else (S, R, n)
    c = randc((S, 3, n)) / math.sqrt(3.0) if tri else randc((S, n))
    c[-1] = 0
    return randc(shape), c, randc(shape[1:])


def _planes(Mg, n, gen, bf16):
    ld = k2.g_ld(n)
    sigma = 0.25 / math.sqrt(n) / math.sqrt(2.0)
    out = []
    for _ in range(2):
        g = torch.zeros((Mg, n, ld))
        g[:, :, :n] = torch.randn((Mg, n, n), generator=gen) * sigma
        out.append(g.to(torch.bfloat16) if bf16 else g)
    return out


def run_case(so, n, kind, bf16, tri, mode, R, stages, sms, gen):
    """One sweep through the host build and through the plain version;
    returns (relative error, blocks, rows a block)."""
    M = n - 6
    lerp = kind == "lerp"
    if lerp:
        g_w, g_lo = sweeping.compress_tables(M, 4)
        g_lo, g_w = torch.from_numpy(g_lo), torch.from_numpy(g_w)
        G = _planes(int(g_lo.max()) + 2, n, gen, bf16)
    else:
        g_lo = g_w = None
        G = _planes(1 if kind == "shared" else M, n, gen, bf16)
    S = M - 1 if mode == "fwd" else M
    u, c, carry0 = _inputs(n, S, R, tri, gen)
    ref = k2.plain_sweep(*G, u, c, carry0, mode=mode, g_lo=g_lo, g_w=g_w)
    width = 1 if R is None else R
    rows = -(-n // sms)
    blocks = -(-n // rows)
    ld = k2.g_ld(n)
    out = torch.empty_like(u)
    scratch = (torch.empty((2, width, n), dtype=u.dtype)
               if tri == (mode == "fwd") else None)
    so.hh_rehearsal_set_sms(sms)
    status = so.hh_sweep(
        k2.MODES.index(mode), int(bf16), G[0].data_ptr(), G[1].data_ptr(),
        0 if kind == "shared" else n * ld, ld, n, S, width, width * n,
        g_lo.data_ptr() if lerp else None, g_w.data_ptr() if lerp else None,
        u.data_ptr(), c.data_ptr(), int(tri), carry0.data_ptr(),
        out.data_ptr(), scratch.data_ptr() if scratch is not None else None,
        blocks, rows, stages, None)
    if status != 0:
        raise RuntimeError(f"hh_sweep returned {status}")
    err = ((out - ref).abs().max() / ref.abs().max()).item()
    return err, blocks, rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--stages", type=int, nargs="+", default=[0, 1, 2])
    ap.add_argument("--ns", type=int, nargs="+", default=[17, 33])
    ap.add_argument("--sms", type=int, default=3,
                    help="SMs of the pretended card: the grid's blocks")
    args = ap.parse_args(argv)
    so = build()
    gen = torch.Generator().manual_seed(0)
    worst, cases = 0.0, 0
    for n, stages in itertools.product(args.ns, args.stages):
        for kind, bf16, tri, mode, R in itertools.product(
                ("dense", "shared", "lerp"), (False, True), (False, True),
                k2.MODES, (None, 3)):
            if kind == "shared" and stages == 2:
                continue          # a shared panel takes one stage at most
            err, blocks, rows = run_case(so, n, kind, bf16, tri, mode,
                                              R, stages, args.sms, gen)
            cases += 1
            worst = max(worst, err)
            if not err <= TOL:
                print(f"FAIL n={n} stages={stages} {kind} bf16={bf16} "
                      f"tri={tri} {mode} R={R}: {err:.3e}", flush=True)
                return 1
        print(f"n={n} stages={stages}: {blocks} blocks of {rows} rows, "
              f"worst relative error so far {worst:.3e}", flush=True)
    print(f"ok: {cases} sweeps, worst relative error {worst:.3e} "
          f"(tolerance {TOL})")
    return 0


if __name__ == "__main__":
    sys.exit(main())
