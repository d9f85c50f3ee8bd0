// Sweep recursion of the moving-PML preconditioner over the corner-inverse
// stack G, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of helmholtz_tpu/ops/pallas/sweep.py
// (wrapper `pallas_sweep`), in all its modes:
//   fwd     : out[k] = u[k] - c[k] * (G[k] @ prev),  prev = carry0 | out[k-1]
//   bwd     : out[j] = G[j] @ (u[j] - c[j] * next),  next = carry0 | out[j+1]
//   bwd_sub : out[j] = u[j] - G[j] @ (u[j] + c[j] * next)
// with the coupling c shared by R right-hand sides (R = 1..4 per launch of
// `sweep_kernel`; any R in one launch of `sweep_kernel_wide`, below), G
// stored as two real planes (re, im) in float32 or bfloat16, c given as
//   diagonal    : c[k] a row of n, applied element-wise (5-point scheme), or
//   tridiagonal : c[k] three rows [sub, diag, sup] of n (9-point scheme),
//                 (c[k] v)[i] = sub[i] v[i-1] + diag[i] v[i] + sup[i] v[i+1],
// and G given in one of three ways:
//   dense  : one panel per step;
//   shared : ONE panel used at every step (panel stride 0);
//   lerp   : sample panels, step k applies
//            G_k = w[k][0] * G[lo[k]] + w[k][1] * G[lo[k] + 1].
// The TPU kernel is a sequential grid that keeps its carry in persistent
// scratch; here the S steps of a sweep run inside ONE persistent launch.
//
// Bound: bytes.  Every step is a dense complex product of one n x n panel
// (8 flops per right-hand side per 4 B of bf16 G, or per 8 B of f32 G)
// against R vectors that depend on the step before, so the panel stream
// from device memory is the limit up to about R = 10 (bf16) or 20 (f32) at
// the H100's published 67 TFLOP/s of float32 FMA: 4.2 MB a step at
// n = 1023 in bf16, 1.27 ms a sweep of 1010 steps at its published
// 3.35 TB/s.  One block cannot pull a panel at that
// rate, and a step lasts about as long as a kernel launch, so the design
// has to split every panel over the whole card AND keep launches and idle
// gaps out of the chain of steps:
//   * ONE cooperative launch a sweep (cudaLaunchCooperativeKernel).  The
//     grid is at most one block per SM (every block must be resident: the
//     launch is refused otherwise, and the entry point returns the error).
//     The step loop runs inside the kernel, with one grid-wide barrier a
//     step, cooperative_groups' grid.sync(), which needs no -rdc build.
//   * Each block owns a fixed contiguous range of rows for the whole sweep
//     (rows_per_block = ceil(n / SMs), 8 at n = 1023 on 132 SMs); its warps
//     take rows, its lanes 16-byte column chunks.  A row's sum is taken in
//     one order, whatever R or the grid: per lane in column order, then a
//     butterfly of warp shuffles, so a right-hand side's sums do not
//     depend on R.
//   * G does not depend on the carry.  A block's rows of the next step's
//     panel (or sample pair) are copied with cp.async into a ring of
//     shared-memory stages BEFORE the block waits at the current step's
//     barrier; each lane copies exactly the chunks it later reads, so its
//     own cp.async.wait_group makes them visible and no block-wide wait is
//     needed for G.  The critical path of a step is then the barrier, the
//     carry (8 R KB) from L2 into shared memory, and a dot against data
//     already on chip.  Two stages where they fit in 227 KB (every bf16
//     variant at n = 1023), else one; with shared G the one panel is
//     loaded once for the sweep; rows too long for any stage (on 132 SMs:
//     bf16 lerp and f32 dense from n = 1849, f32 lerp from n = 1321) are
//     read from device memory directly.
//   * Nothing the epilogue needs waits after the dot: u and c of a warp's
//     row, and the lerp weights, are loaded before the prologue.  With
//     diagonal coupling in bwd / bwd_sub, the owner of out[k][i] also
//     forms the next step's operand element u[k-1][i] -+ c[k-1][i]
//     out[k][i] into one of two scratch rows, so the next prologue reads
//     one vector of 8 R KB where every block would read three.
//   * Coherence: the carry (`out`, the two scratch rows) is written by
//     other blocks of the same launch, so it is read with __ldcg (L2),
//     never through the non-coherent read-only path; G, u and c are inputs
//     and may take it.
// Not chosen: a CUDA graph of per-step launches.  It removes the host's
// launch cost but keeps S launch gaps on the device, and step k + 1's G
// stream cannot start before step k's kernel has ended.
//
// R > 1: a lane loads its 16 bytes of the G row ONCE and multiplies them
// into R pairs of accumulators, so R solves ride one stream of G.  The
// operand in shared memory is 2 * R * ld floats (32 KB at R = 4,
// ld = 1024).  The coupling prologue and the epilogue run per right-hand
// side with the shared c.
//
// lerp: a warp takes its row's dot product against panel lo[k] and against
// panel lo[k] + 1 and combines the two sums as w0 * acc0 + w1 * acc1 in
// float32, on the outputs, as the TPU kernel does.  Every block reads lo[k]
// and the weights from device memory; nothing goes through the host.  The
// function itself, (w0 G[lo] + w1 G[lo+1]) @ V, needs one combine of the
// two panels and ONE product, (8 R + 6) n^2 operations a step, and its
// bound counts that; this kernel spends two products a step (16 R n^2) to
// keep the weights on the outputs.  Consecutive steps share their pair of
// sample panels, which L2 (50 MB) holds.
//
// Tridiagonal coupling.  In bwd / bwd_sub the coupling acts on `other`,
// which every block reads whole in its prologue anyway: element i takes
// other[i-1], other[i], other[i+1] and three coefficient rows.  In fwd it
// acts on the PRODUCT w = G[k] @ prev, whose neighbouring rows belong to
// other warps and, at a block's edge, to other blocks.  Each fwd step
// stores its RAW product w_k into one of two scratch rows (ping-pong: a
// step's blocks read w_{k-1} while others write w_k), and the NEXT step's
// prologue, which reads the whole vector anyway, forms prev = out[k] =
// u[k] - c[k] w_k; the block that owns rows of out[k] also stores them.
// After the last step one more barrier, and every block finishes its own
// rows of the last out.  So G is still read once a step, a sweep is still
// one launch, and every sum has a fixed order (no float atomics).
// Assembly zeroes sub[0] and sup[n-1], but the kernel does not lean on it:
// it never reads index -1 or n (with R > 1 those are the neighbouring
// right-hand side's memory), so those two slots are ignored whatever they
// hold, as the plain version's shifted slices ignore them.
//
// Each lane moves 16 bytes of a row at a time (8 bf16 or 4 f32 values), so
// a row must start 16-byte aligned: the planes are (Mg, n, ld) with row
// pitch ld = ceil(n / 8) * 8 elements (1024 at n = 1023) and zero pad
// columns.  The vector operands live in shared memory as float32, zero
// padded to ld.
//
// Precision: a bf16 G value is widened to float32 in registers and
// multiplied by the float32 vector with float32 FMA, which is exact for
// the product.  The hi+lo bf16 split of the carry that the TPU kernel
// needs for its bf16 matrix unit is therefore not needed here; it would
// return only if the product moved to the tensor cores.  float32 G uses
// plain float32 FMA (no TF32 anywhere).
//
// The wide kernel, `sweep_kernel_wide`: dense G, diagonal coupling, R > 4.
// Past about R = 10 (bf16) or 20 (f32) a step is bound by operations, not
// by the panel: at R = 64 and n = 1023 it is a (1023 x 1023) (1023 x 64)
// complex product, 536 MFLOP, 8.0 us at 67 TFLOP/s, against 1.25 us to
// stream its bf16 panel.  The kernel above cannot feed the FMA pipes
// there: its operand sits in shared memory whole (8 KB a right-hand side at
// ld = 1024), every block reads the whole carry every step, and one warp
// owns one row, so a loaded operand value feeds one row.  Walking a batch
// in launches of four streams G and pays the chain of ~1,010 grid barriers
// once a launch.  The wide kernel takes the whole batch in ONE cooperative
// launch, still one grid barrier a step:
//   * The step's output (rows x right-hand sides) is cut in two dimensions
//     over the resident grid: a block owns 8 TR rows (TR = 1, 2, 4 or 8, a
//     template width) and a slice of 16 right-hand sides for the whole
//     sweep, so it reads only its rows of G and only its slice of the
//     carry.  The launch plan (ops/kernels/sweep.py `wide_plan`) picks the
//     smallest TR whose row groups x slices fit one block an SM: at
//     n = 1023, R = 64, 32 row groups x 4 slices; at R = 16, 128 row
//     groups of 8 rows.  A slice past R is padded: its lanes compute, but
//     read and write no memory.
//   * Register tiles.  A lane holds TR rows x 4 right-hand sides of
//     complex accumulators (rows li + 8 q, right-hand sides lj + 4 q; lane
//     = li + 8 lj), so each 16 bytes of G it loads feed 4 right-hand sides
//     and each operand value TR rows.  The 8 warps split the columns (k):
//     warp w takes KS = 16 (bf16) or 8 (f32) columns of every k tile.
//   * k tiles through a ring of 2-4 shared-memory stages (cp.async): a
//     tile is 256 bytes of each of the block's G rows (128 bf16 / 64 f32
//     columns) and the same columns of its 16 operand rows.  Each warp
//     copies exactly its own columns, so a warp waits on its own copies
//     and a __syncwarp, never on the block.  G does not depend on the
//     carry: the first stages - 1 tiles of the next step's panel are
//     copied BEFORE the block waits at the barrier.
//   * The operand of every step is one vector of R rows at pitch ld in
//     two scratch rows (ping-pong, pad columns zero): the owner of out[k]
//     also writes the next step's operand element, out[k] (fwd) or
//     u[k-1] -+ c[k-1] out[k] (bwd / bwd_sub), so the next step copies it
//     with 16-byte cp.async (out itself has pitch n, 8-byte aligned) and
//     reads it through L2 (cp.async.cg), coherent after the barrier.  A
//     first barrier publishes step 0's operand from carry0.
//   * Fixed order: the 8 warps' partial sums go through shared memory and
//     are added in warp order; within a warp a lane adds its columns in
//     order.  So an output's sum depends only on n, not on R, the grid or
//     the other right-hand sides; there are no atomics.  The epilogue's
//     products and sums are rounded one by one (__fmul_rn, __fadd_rn), so
//     no template instance contracts them differently.
// Products are float32 FMA on the CUDA cores, accumulators float32, as
// above.
#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <map>
#include <mutex>

namespace cg = cooperative_groups;

namespace {

constexpr int kMaxWarps = 8;
constexpr int kMaxThreads = kMaxWarps * 32;
constexpr int kMaxRhs = 4;
constexpr int kMaxStages = 2;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB, the most a block gets

enum Mode { kFwd = 0, kBwd = 1, kBwdSub = 2 };

// 16 bytes of a G row, widened to float32.  The pointer is generic: a
// stage in shared memory, or device memory when no stage fits.
template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
    static constexpr int kElems = 4;
    __device__ static void load(const float* p, float (&v)[4]) {
        const float4 q = *reinterpret_cast<const float4*>(p);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
};

template <>
struct Vec16<__nv_bfloat16> {
    static constexpr int kElems = 8;
    __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
        const uint4 q = *reinterpret_cast<const uint4*>(p);
        const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            // a bf16 is the upper half of a float32
            v[2 * t] = __uint_as_float(w[t] << 16);
            v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
        }
    }
};

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
    const unsigned int s =
        static_cast<unsigned int>(__cvta_generic_to_shared(smem));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(s), "l"(gmem) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
    asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// What one sweep is given.  u, out: (S, R_total, n) complex64 with
// `row_stride` = R_total * n elements between steps; this launch handles R
// consecutive right-hand sides starting where the pointers point.
// c: (S, n), or (S, 3, n) when tri.  carry0: R rows of n.  g_lo, g_w: the
// lerp tables, or null.  scratch: 2 * R * n complex words, for fwd with
// tri.  Block b owns rows [b * rows_per_block, (b + 1) * rows_per_block)
// of every step; `stages` is the depth of the ring of G in shared memory
// (0: G is read from device memory directly).
struct SweepArgs {
    const void* g_re;
    const void* g_im;
    long long panel_stride;
    int ld, n, S;
    long long row_stride;
    const int* g_lo;
    const float* g_w;
    const float2* u;
    const float2* c;
    const float2* carry0;
    float2* out;
    float2* scratch;
    int rows_per_block, stages;
};

__device__ __forceinline__ float2 cmul_add(float2 a, float2 b, float2 acc) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
    return acc;
}

// One element of the operand of a backward step with diagonal coupling:
// u - c * o (bwd) or u + c * o (bwd_sub).
template <int MODE>
__device__ __forceinline__ float2 couple(float2 ui, float2 ci, float2 o) {
    const float pr = ci.x * o.x - ci.y * o.y;
    const float pi = ci.x * o.y + ci.y * o.x;
    return (MODE == kBwd) ? make_float2(ui.x - pr, ui.y - pi)
                          : make_float2(ui.x + pr, ui.y + pi);
}

// Prologue of a step with diagonal coupling: fills the shared operand with
// other (fwd), u - c * other (bwd) or u + c * other (bwd_sub).
template <int MODE, int R>
__device__ __forceinline__ void diag_prologue(
        float* vr, float* vi, const float2* __restrict__ u,
        const float2* __restrict__ c, const float2* other, int n, int ld) {
    // Loads first, uses after: a thread fetches its kBatch elements of
    // every stream and every right-hand side before it combines any, so
    // the step pays one round trip to L2, not one per right-hand side.
    // Elements past n load nothing and combine to the zero padding.
    constexpr int kBatch = 4;
    const int nt = blockDim.x;
    for (int base = threadIdx.x; base < ld; base += kBatch * nt) {
        float2 o[R][kBatch], ui[R][kBatch], ci[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int i = base + j * nt;
            ci[j] = make_float2(0.f, 0.f);
#pragma unroll
            for (int r = 0; r < R; ++r)
                o[r][j] = ui[r][j] = make_float2(0.f, 0.f);
            if (i < n) {
                if (MODE != kFwd) ci[j] = c[i];
#pragma unroll
                for (int r = 0; r < R; ++r) {
                    o[r][j] = __ldcg(other + r * n + i);
                    if (MODE != kFwd) ui[r][j] = u[r * n + i];
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int i = base + j * nt;
            if (i >= ld) continue;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                const float2 v = (MODE == kFwd)
                    ? o[r][j] : couple<MODE>(ui[r][j], ci[j], o[r][j]);
                vr[r * ld + i] = v.x;
                vi[r * ld + i] = v.y;
            }
        }
    }
}

__device__ __forceinline__ float2 shfl_up2(float2 v) {
    return make_float2(__shfl_up_sync(0xffffffffu, v.x, 1),
                       __shfl_up_sync(0xffffffffu, v.y, 1));
}

__device__ __forceinline__ float2 shfl_down2(float2 v) {
    return make_float2(__shfl_down_sync(0xffffffffu, v.x, 1),
                       __shfl_down_sync(0xffffffffu, v.y, 1));
}

// Prologue of a step with tridiagonal coupling: fills the shared operand
//   v = base -+ c x,   c = [sub, diag, sup] rows of n,
// for R right-hand sides.  bwd / bwd_sub: base = u[k], x = next, sign - / +.
// fwd: base = u[k-1], x = the raw product w_{k-1} of the step before, sign -,
// so v = out[k-1] = prev, and the block stores the elements of its own rows
// [own_lo, own_hi) to `store`; at the first step (`first`) v is x = carry0
// as it is.  Neighbouring lanes hold neighbouring elements, so x[i-1] and
// x[i+1] come from the next lanes by shuffle; lanes 0 and 31 load the one
// neighbour outside their warp.  x[i-1] and x[i+1] are read only inside
// 0..n-1.  Loads first, uses after, one round trip for every right-hand
// side, as above.
template <int MODE, int R>
__device__ __forceinline__ void tri_prologue(
        float* vr, float* vi, const float2* __restrict__ base,
        const float2* __restrict__ c, const float2* x, float2* store,
        bool first, int n, int ld, int own_lo, int own_hi) {
    constexpr int kBatch = 4;
    const int nt = blockDim.x;
    const int lane = threadIdx.x & 31;
    const float2 zero = make_float2(0.f, 0.f);
    // the whole warp takes every pass together: the shuffles need all lanes
    for (int w0 = threadIdx.x - lane; w0 < ld; w0 += kBatch * nt) {
        const int i0 = w0 + lane;
        float2 x0[R][kBatch], xe[R][kBatch], bs[R][kBatch];
        float2 sub[kBatch], dia[kBatch], sup[kBatch];
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int i = i0 + j * nt;
            sub[j] = dia[j] = sup[j] = zero;
#pragma unroll
            for (int r = 0; r < R; ++r) x0[r][j] = xe[r][j] = bs[r][j] = zero;
            if (i < n) {
#pragma unroll
                for (int r = 0; r < R; ++r) x0[r][j] = __ldcg(x + r * n + i);
                if (!first) {
                    if (i > 0) sub[j] = c[i];
                    if (i + 1 < n) sup[j] = c[2 * n + i];
                    dia[j] = c[n + i];
#pragma unroll
                    for (int r = 0; r < R; ++r) {
                        bs[r][j] = base[r * n + i];
                        if (lane == 0 && i > 0)
                            xe[r][j] = __ldcg(x + r * n + i - 1);
                        else if (lane == 31 && i + 1 < n)
                            xe[r][j] = __ldcg(x + r * n + i + 1);
                    }
                }
            }
        }
#pragma unroll
        for (int j = 0; j < kBatch; ++j) {
            const int i = i0 + j * nt;
#pragma unroll
            for (int r = 0; r < R; ++r) {
                float2 v = x0[r][j];
                if (!first) {
                    // every lane shuffles, inside the row or not
                    float2 xm = shfl_up2(x0[r][j]);
                    float2 xp = shfl_down2(x0[r][j]);
                    if (lane == 0) xm = xe[r][j];
                    if (lane == 31) xp = xe[r][j];
                    float2 t = zero;
                    t = cmul_add(sub[j], xm, t);
                    t = cmul_add(dia[j], x0[r][j], t);
                    t = cmul_add(sup[j], xp, t);
                    v = (MODE == kBwdSub)
                        ? make_float2(bs[r][j].x + t.x, bs[r][j].y + t.y)
                        : make_float2(bs[r][j].x - t.x, bs[r][j].y - t.y);
                    if (MODE == kFwd && i < n && i >= own_lo && i < own_hi)
                        store[r * n + i] = v;
                }
                if (i < ld) {
                    vr[r * ld + i] = v.x;
                    vi[r * ld + i] = v.y;
                }
            }
        }
    }
}

// The sums of one row against the shared operand, per panel p and
// right-hand side r, reduced over the warp: every lane holds every sum.
// A lane takes the 16-byte chunks lane * E, lane * E + 32 E, ... in order.
template <typename T, int R, int P, bool LERP>
__device__ __forceinline__ void row_dot(
        const T* const* g_re, const T* const* g_im,
        const float* vr, const float* vi, int ld, int lane,
        float (&acc_re)[P][R], float (&acc_im)[P][R]) {
    constexpr int E = Vec16<T>::kElems;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc_re[p][r] = acc_im[p][r] = 0.f;
    }
    constexpr int kUnroll = (R == 1 && !LERP) ? 4 : 2;
#pragma unroll (kUnroll)
    for (int col = lane * E; col < ld; col += 32 * E) {
        float gr[P][E], gi[P][E];
#pragma unroll
        for (int p = 0; p < P; ++p) {
            Vec16<T>::load(g_re[p] + col, gr[p]);
            Vec16<T>::load(g_im[p] + col, gi[p]);
        }
#pragma unroll
        for (int q = 0; q < E; q += 4) {
#pragma unroll
            for (int r = 0; r < R; ++r) {
                // 16-byte shared loads: col is a multiple of 4, ld of 8
                const float4 a = *reinterpret_cast<const float4*>(
                    vr + r * ld + col + q);
                const float4 b = *reinterpret_cast<const float4*>(
                    vi + r * ld + col + q);
                const float xr[4] = {a.x, a.y, a.z, a.w};
                const float xi[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
                for (int p = 0; p < P; ++p) {
#pragma unroll
                    for (int t = 0; t < 4; ++t) {
                        const float g_r = gr[p][q + t];
                        const float g_i = gi[p][q + t];
                        acc_re[p][r] = fmaf(g_r, xr[t], acc_re[p][r]);
                        acc_re[p][r] = fmaf(-g_i, xi[t], acc_re[p][r]);
                        acc_im[p][r] = fmaf(g_r, xi[t], acc_im[p][r]);
                        acc_im[p][r] = fmaf(g_i, xr[t], acc_im[p][r]);
                    }
                }
            }
        }
    }
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int r = 0; r < R; ++r) {
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                acc_re[p][r] += __shfl_xor_sync(0xffffffffu, acc_re[p][r], off);
                acc_im[p][r] += __shfl_xor_sync(0xffffffffu, acc_im[p][r], off);
            }
        }
    }
}

// One whole sweep.  Shared memory: vr[R][ld], vi[R][ld] = the vectors the
// panel is multiplied with, then `stages` stages of G, each the block's
// rows as [row][panel p][plane re, im][ld].
template <typename T, int MODE, int R, bool LERP, bool TRI>
__global__ void __launch_bounds__(kMaxThreads)
sweep_kernel(const SweepArgs a) {
    extern __shared__ __align__(16) float smem[];
    constexpr int P = LERP ? 2 : 1;     // panels read per step
    constexpr int E = Vec16<T>::kElems;
    // fwd with tridiagonal coupling: step k leaves its raw product in
    // scratch row k % 2 and the next step finishes row k (see the note)
    constexpr bool kDeferred = TRI && MODE == kFwd;
    // bwd / bwd_sub with diagonal coupling: the owner of an element of
    // out[k] also forms that element of the next step's operand, u[k-1] -+
    // c[k-1] out[k], into scratch row (s + 1) % 2, so the next prologue
    // reads one vector and not three
    constexpr bool kOwnerOperand = !TRI && MODE != kFwd;
    const int ld = a.ld, n = a.n, S = a.S;
    float* vr = smem;
    float* vi = smem + R * ld;
    T* ring = reinterpret_cast<T*>(smem + 2 * R * ld);
    const T* g_re = static_cast<const T*>(a.g_re);
    const T* g_im = static_cast<const T*>(a.g_im);

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int warps = blockDim.x >> 5;
    const int own_lo = blockIdx.x * a.rows_per_block;
    const int own_n = min(a.rows_per_block, n - own_lo);
    const size_t stage_elems = (size_t)a.rows_per_block * P * 2 * ld;
    const size_t c_stride = (size_t)(TRI ? 3 : 1) * n;
    // shared G: the one panel is loaded once for the whole sweep
    const bool resident = a.panel_stride == 0 && !LERP;
    float2* buf[2] = {a.scratch, a.scratch ? a.scratch + (size_t)R * n
                                           : nullptr};
    cg::grid_group grid = cg::this_grid();

    // fwd walks rows first to last, the backward modes last to first; step
    // row k uses panel k (dense), the one shared panel, or the pair of
    // sample panels that the tables name for k (lerp)
    auto step_row = [&](int s) { return MODE == kFwd ? s : S - 1 - s; };
    auto panel_of = [&](int k) -> long long {
        return LERP ? (long long)__ldg(a.g_lo + k) : (long long)k;
    };
    // Copy step s's rows of G into stage s % stages and commit one group
    // (empty past the last step, so that every thread counts alike).
    auto prefetch = [&](int s) {
        if (s < S) {
            const long long panel = panel_of(step_row(s));
            T* stage = ring + (size_t)(s % a.stages) * stage_elems;
            for (int lr = warp; lr < own_n; lr += warps) {
                const size_t g_off = (size_t)panel * a.panel_stride
                                     + (size_t)(own_lo + lr) * ld;
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    const size_t off = g_off + (size_t)p * a.panel_stride;
                    T* d = stage + (size_t)(lr * P + p) * 2 * ld;
                    for (int col = lane * E; col < ld; col += 32 * E) {
                        cp_async16(d + col, g_re + off + col);
                        cp_async16(d + ld + col, g_im + off + col);
                    }
                }
            }
        }
        cp_async_commit();
    };

    if (a.stages > 0) {
        prefetch(0);
        if (!resident && a.stages > 1) prefetch(1);
    }
    for (int s = 0; s < S; ++s) {
        const int k = step_row(s);
        // the row whose u, c and out the prologue is handed
        const int row = (kDeferred && s > 0) ? k - 1 : k;
        const float2* other;
        if (s == 0) {
            other = a.carry0;
        } else if (kDeferred) {
            other = buf[(k - 1) % 2];
        } else {
            other = a.out + (size_t)((MODE == kFwd) ? k - 1 : k + 1)
                                * a.row_stride;
        }
        const float2* u = a.u + (size_t)row * a.row_stride;
        const float2* c = a.c + (size_t)row * c_stride;
        float2* out = a.out + (size_t)row * a.row_stride;
        // What the epilogue of the warp's first row needs besides the sums,
        // loaded before the prologue so that no load waits after the dot:
        // lane r < R takes u and c of its element (fwd, bwd_sub), and with
        // the owner's operand those of the next step's element too.
        const int grow0 = own_lo + warp;
        const bool pre = warp < own_n && lane < R;
        const bool has_next = kOwnerOperand && s + 1 < S;
        const float2 zero = make_float2(0.f, 0.f);
        float2 pre_u = zero, pre_c = zero, pre_nu = zero, pre_nc = zero;
        if (pre && !kDeferred && MODE != kBwd) {
            pre_u = u[lane * n + grow0];
            if (MODE == kFwd) pre_c = c[grow0];
        }
        if (pre && has_next) {
            pre_nu = u[lane * n + grow0 - a.row_stride];
            pre_nc = c[grow0 - c_stride];
        }
        float w0 = 1.f, w1 = 0.f;
        if (LERP) {
            w0 = __ldg(a.g_w + 2 * k);
            w1 = __ldg(a.g_w + 2 * k + 1);
        }
        if (TRI) {
            tri_prologue<MODE, R>(vr, vi, u, c, other, out,
                                  MODE == kFwd && s == 0, n, ld, own_lo,
                                  own_lo + own_n);
        } else if (kOwnerOperand && s > 0) {
            // the owners published this step's operand: copy it
            diag_prologue<kFwd, R>(vr, vi, u, c, buf[s % 2], n, ld);
        } else {
            diag_prologue<MODE, R>(vr, vi, u, c, other, n, ld);
        }
        // this thread's copies of step s have landed (it reads only those)
        if (a.stages == 2 && !resident) {
            cp_async_wait<1>();
        } else if (a.stages > 0) {
            cp_async_wait<0>();
        }
        __syncthreads();

        for (int lr = warp; lr < own_n; lr += warps) {
            const int grow = own_lo + lr;
            const bool first_row = lr == warp;
            const T* pr_row[P];
            const T* pi_row[P];
            if (a.stages > 0) {
                const T* base = ring
                    + (size_t)(resident ? 0 : s % a.stages) * stage_elems
                    + (size_t)lr * P * 2 * ld;
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    pr_row[p] = base + (size_t)p * 2 * ld;
                    pi_row[p] = base + (size_t)p * 2 * ld + ld;
                }
            } else {
                const size_t g_off = (size_t)panel_of(k) * a.panel_stride
                                     + (size_t)grow * ld;
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    pr_row[p] = g_re + g_off + (size_t)p * a.panel_stride;
                    pi_row[p] = g_im + g_off + (size_t)p * a.panel_stride;
                }
            }
            float acc_re[P][R], acc_im[P][R];
            row_dot<T, R, P, LERP>(pr_row, pi_row, vr, vi, ld, lane, acc_re,
                                   acc_im);
            // lane r finishes right-hand side r
#pragma unroll
            for (int r = 0; r < R; ++r) {
                if (lane != r) continue;
                float sr = acc_re[0][r], si = acc_im[0][r];
                if (LERP) {
                    sr = w0 * sr + w1 * acc_re[P - 1][r];
                    si = w0 * si + w1 * acc_im[P - 1][r];
                }
                float2 res;
                if (kDeferred) {
                    buf[k % 2][r * n + grow] = make_float2(sr, si);
                    continue;
                } else if (MODE == kFwd) {
                    const float2 ci = first_row ? pre_c : c[grow];
                    const float2 ui = first_row ? pre_u : u[r * n + grow];
                    res.x = ui.x - (ci.x * sr - ci.y * si);
                    res.y = ui.y - (ci.x * si + ci.y * sr);
                } else if (MODE == kBwd) {
                    res = make_float2(sr, si);
                } else {
                    const float2 ui = first_row ? pre_u : u[r * n + grow];
                    res = make_float2(ui.x - sr, ui.y - si);
                }
                out[r * n + grow] = res;
                if (has_next) {
                    // this element of the next step's operand
                    const float2 nu = first_row
                        ? pre_nu : u[r * n + grow - a.row_stride];
                    const float2 nc = first_row ? pre_nc
                                                : c[grow - c_stride];
                    buf[(s + 1) % 2][r * n + grow] = couple<MODE>(nu, nc, res);
                }
            }
        }
        // this thread has read its chunks of stage s % stages: refill it
        if (a.stages > 0 && !resident) prefetch(s + a.stages);
        if (s + 1 < S || kDeferred) grid.sync();
    }

    if (kDeferred) {
        // the last row: out = u - c w for this block's rows
        const int last = S - 1;
        const float2* u = a.u + (size_t)last * a.row_stride;
        const float2* c = a.c + (size_t)last * c_stride;
        const float2* w = buf[last % 2];
        float2* out = a.out + (size_t)last * a.row_stride;
        for (int idx = threadIdx.x; idx < R * own_n; idx += blockDim.x) {
            const int r = idx / own_n, i = own_lo + idx % own_n;
            float2 t = make_float2(0.f, 0.f);
            if (i > 0) t = cmul_add(c[i], __ldcg(w + r * n + i - 1), t);
            t = cmul_add(c[n + i], __ldcg(w + r * n + i), t);
            if (i + 1 < n) t = cmul_add(c[2 * n + i], __ldcg(w + r * n + i + 1),
                                        t);
            const float2 ui = u[r * n + i];
            out[r * n + i] = make_float2(ui.x - t.x, ui.y - t.y);
        }
    }
}

// -- the wide kernel ----------------------------------------------------------

constexpr int kWideWarps = 8;
constexpr int kWideThreads = 32 * kWideWarps;
constexpr int kSliceRhs = 16;        // a block's right-hand sides: 4 lanes x 4
constexpr int kTileRowBytes = 256;   // bytes of one G row in one k tile
constexpr int kWideMinStages = 2;
constexpr int kWideMaxStages = 4;

// What one wide sweep is given: as SweepArgs for dense G and diagonal
// coupling, with R right-hand sides in the launch.  scratch: 2 x R x ld
// complex words, pad columns [n, ld) zero.  Block b owns rows
// [(b % row_groups) * 8 TR, ...) and right-hand sides
// [(b / row_groups) * 16, ...).
struct WideArgs {
    const void* g_re;
    const void* g_im;
    long long panel_stride;
    int ld, n, S, R;
    long long row_stride;
    const float2* u;
    const float2* c;
    const float2* carry0;
    float2* out;
    float2* scratch;
    int row_groups, stages;
};

// The layout of a ring stage, in bytes: the G tile (two planes of `rows`
// rows at pitch kTileRowBytes + 16, so that 8 lanes reading 8 consecutive
// rows hit 8 different bank groups), then the operand tile (16 right-hand
// sides of complex64 at pitch 16 bytes past its columns, likewise).
__host__ __device__ constexpr int wide_tile_k(int g_bytes) {
    return kTileRowBytes / g_bytes;
}
__host__ __device__ constexpr int wide_g_pitch() { return kTileRowBytes + 16; }
__host__ __device__ constexpr int wide_v_pitch(int g_bytes) {
    return wide_tile_k(g_bytes) * 8 + 16;
}
__host__ __device__ constexpr int wide_stage_bytes(int rows, int g_bytes) {
    return 2 * rows * wide_g_pitch() + kSliceRhs * wide_v_pitch(g_bytes);
}

// a * b with each product rounded, then summed: no contraction into FMA
__device__ __forceinline__ float2 cmul_rn(float2 a, float2 b) {
    return make_float2(__fsub_rn(__fmul_rn(a.x, b.x), __fmul_rn(a.y, b.y)),
                       __fadd_rn(__fmul_rn(a.x, b.y), __fmul_rn(a.y, b.x)));
}

// u - c * o (bwd) or u + c * o (bwd_sub), rounded as cmul_rn
template <int MODE>
__device__ __forceinline__ float2 couple_rn(float2 ui, float2 ci, float2 o) {
    const float2 p = cmul_rn(ci, o);
    return (MODE == kBwd)
        ? make_float2(__fsub_rn(ui.x, p.x), __fsub_rn(ui.y, p.y))
        : make_float2(__fadd_rn(ui.x, p.x), __fadd_rn(ui.y, p.y));
}

// Wait until at most `pending` of this thread's cp.async groups are in
// flight (the instruction takes an immediate).
__device__ __forceinline__ void cp_async_wait_at_most(int pending) {
    if (pending <= 0) {
        cp_async_wait<0>();
    } else if (pending == 1) {
        cp_async_wait<1>();
    } else {
        cp_async_wait<2>();
    }
}

// The lane's sums over this warp's columns [kk0, kk0 + KS) of one k tile,
// kk0 relative to the tile, `valid` of them inside the row pitch: its TR
// rows of G (li + 8 q) against its 4 right-hand sides (lj + 4 q) of the
// operand tile.  Column by column, in order.
template <typename T, int TR>
__device__ __forceinline__ void wide_tile_product(
        const unsigned char* stage, int kk0, int valid, int li, int lj,
        float (&acc_re)[TR][4], float (&acc_im)[TR][4]) {
    constexpr int E = Vec16<T>::kElems;
    constexpr int KS = wide_tile_k(sizeof(T)) / kWideWarps;
    constexpr int BR = 8 * TR;
    constexpr int GP = wide_g_pitch();
    constexpr int VP = wide_v_pitch(sizeof(T));
    constexpr int G_PART = 2 * BR * GP;
#pragma unroll
    for (int h = 0; h < KS / E; ++h) {
        if (h * E >= valid) break;            // the same for the whole warp
        const int kk = kk0 + h * E;
        float xr[4][E], xi[4][E];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            const float4* v = reinterpret_cast<const float4*>(
                stage + G_PART + (lj + 4 * q) * VP + kk * 8);
#pragma unroll
            for (int e = 0; e < E / 2; ++e) {
                const float4 p = v[e];
                xr[q][2 * e] = p.x;
                xi[q][2 * e] = p.y;
                xr[q][2 * e + 1] = p.z;
                xi[q][2 * e + 1] = p.w;
            }
        }
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) {
            float gr[E], gi[E];
            const unsigned char* g = stage + (li + 8 * rr) * GP
                                     + kk * (int)sizeof(T);
            Vec16<T>::load(reinterpret_cast<const T*>(g), gr);
            Vec16<T>::load(reinterpret_cast<const T*>(g + BR * GP), gi);
#pragma unroll
            for (int e = 0; e < E; ++e) {
#pragma unroll
                for (int q = 0; q < 4; ++q) {
                    acc_re[rr][q] = fmaf(gr[e], xr[q][e], acc_re[rr][q]);
                    acc_re[rr][q] = fmaf(-gi[e], xi[q][e], acc_re[rr][q]);
                    acc_im[rr][q] = fmaf(gr[e], xi[q][e], acc_im[rr][q]);
                    acc_im[rr][q] = fmaf(gi[e], xr[q][e], acc_im[rr][q]);
                }
            }
        }
    }
}

// One whole sweep of R right-hand sides.  Shared memory: `stages` ring
// stages (wide_stage_bytes), then the warps' partial sums, [warp][right-hand
// side][row] complex.
template <typename T, int MODE, int TR>
__global__ void __launch_bounds__(kWideThreads, 1)
sweep_kernel_wide(const WideArgs a) {
    extern __shared__ __align__(16) unsigned char wide_smem[];
    constexpr int G_BYTES = (int)sizeof(T);
    constexpr int E = Vec16<T>::kElems;
    constexpr int KT = wide_tile_k(G_BYTES);
    constexpr int KS = KT / kWideWarps;
    constexpr int BR = 8 * TR;
    constexpr int GP = wide_g_pitch();
    constexpr int VP = wide_v_pitch(G_BYTES);
    constexpr int G_PART = 2 * BR * GP;
    constexpr int STAGE = wide_stage_bytes(BR, G_BYTES);
    constexpr int OUTS = BR * kSliceRhs;
    constexpr int PER_THREAD = (OUTS + kWideThreads - 1) / kWideThreads;
    const int ld = a.ld, n = a.n, S = a.S, R = a.R;
    const long long rs = a.row_stride;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int li = lane & 7, lj = lane >> 3;
    const int row0 = (blockIdx.x % a.row_groups) * BR;
    const int rhs0 = (blockIdx.x / a.row_groups) * kSliceRhs;
    const int nst = a.stages;
    const int tiles = (ld + KT - 1) / KT;
    float2* red = reinterpret_cast<float2*>(wide_smem + (size_t)nst * STAGE);
    const T* planes[2] = {static_cast<const T*>(a.g_re),
                          static_cast<const T*>(a.g_im)};
    float2* buf[2] = {a.scratch, a.scratch + (size_t)R * ld};
    cg::grid_group all_blocks = cg::this_grid();
    auto step_row = [&](int s) { return MODE == kFwd ? s : S - 1 - s; };

    // This warp's columns of k tile t: of panel k's rows of the block
    // (both planes, two 16-byte chunks a row) and of the operand's
    // right-hand sides of the block, into ring stage `slot`.  Rows past n,
    // right-hand sides past R and columns past ld are not copied.
    auto load_g = [&](int k, int t, int slot) {
        const int col = t * KT + warp * KS;
        unsigned char* st = wide_smem + (size_t)slot * STAGE;
        for (int idx = lane; idx < 4 * BR; idx += 32) {
            const int half = idx & 1, row = (idx >> 1) % BR;
            const int plane = idx / (2 * BR);
            const int grow = row0 + row, c0 = col + half * E;
            if (grow < n && c0 < ld)
                cp_async16(st + plane * BR * GP + row * GP
                               + (warp * KS + half * E) * G_BYTES,
                           planes[plane] + (size_t)k * a.panel_stride
                               + (size_t)grow * ld + c0);
        }
    };
    auto load_v = [&](const float2* operand, int t, int slot) {
        constexpr int PER_RHS = KS / 2;      // 16-byte chunks: two complex
        const int col = t * KT + warp * KS;
        unsigned char* st = wide_smem + (size_t)slot * STAGE + G_PART;
        for (int idx = lane; idx < kSliceRhs * PER_RHS; idx += 32) {
            const int part = idx % PER_RHS, rl = idx / PER_RHS;
            const int r = rhs0 + rl, c0 = col + 2 * part;
            if (r < R && c0 < ld)
                cp_async16(st + rl * VP + (warp * KS + 2 * part) * 8,
                           operand + (size_t)r * ld + c0);
        }
    };

    // step 0's operand, from carry0: each block its own elements
    {
        const int k = step_row(0);
        for (int idx = threadIdx.x; idx < OUTS; idx += kWideThreads) {
            const int i = row0 + idx % BR, r = rhs0 + idx / BR;
            if (i < n && r < R) {
                const float2 o = a.carry0[(size_t)r * n + i];
                buf[0][(size_t)r * ld + i] = (MODE == kFwd) ? o
                    : couple_rn<MODE>(a.u[k * rs + (size_t)r * n + i],
                                      a.c[(size_t)k * n + i], o);
            }
        }
    }
    for (int t = 0; t < nst - 1 && t < tiles; ++t) load_g(step_row(0), t, t);
    cp_async_commit();
    all_blocks.sync();

    for (int s = 0; s < S; ++s) {
        const int k = step_row(s);
        const bool next = s + 1 < S;
        const float2* operand = buf[s & 1];
        // what the epilogue needs besides the sums, loaded now: u and c of
        // the thread's outputs (fwd, bwd_sub), and of the next step's
        // operand elements (bwd, bwd_sub)
        const float2 zero = make_float2(0.f, 0.f);
        float2 pu[PER_THREAD], pc[PER_THREAD], pnu[PER_THREAD],
            pnc[PER_THREAD];
#pragma unroll
        for (int o = 0; o < PER_THREAD; ++o) {
            const int idx = threadIdx.x + o * kWideThreads;
            const int i = row0 + idx % BR, r = rhs0 + idx / BR;
            pu[o] = pc[o] = pnu[o] = pnc[o] = zero;
            if (idx < OUTS && i < n && r < R) {
                if (MODE != kBwd) pu[o] = a.u[k * rs + (size_t)r * n + i];
                if (MODE == kFwd) pc[o] = a.c[(size_t)k * n + i];
                if (MODE != kFwd && next) {
                    pnu[o] = a.u[(k - 1) * rs + (size_t)r * n + i];
                    pnc[o] = a.c[(size_t)(k - 1) * n + i];
                }
            }
        }
        // the operand's first tiles; G's came before the barrier
        for (int t = 0; t < nst - 1; ++t) {
            if (t < tiles) load_v(operand, t, t);
            cp_async_commit();
        }
        float acc_re[TR][4], acc_im[TR][4];
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) {
#pragma unroll
            for (int q = 0; q < 4; ++q) acc_re[rr][q] = acc_im[rr][q] = 0.f;
        }
        // tile t is this thread's t-th group since the barrier: wait for it,
        // let the warp see its lanes' copies (and finish tile t - 1, whose
        // stage the next copies refill), copy tile t + stages - 1, multiply
        for (int t = 0; t < tiles; ++t) {
            cp_async_wait_at_most(nst - 2);
            __syncwarp();
            const int ahead = t + nst - 1;
            if (ahead < tiles) {
                load_g(k, ahead, ahead % nst);
                load_v(operand, ahead, ahead % nst);
            }
            cp_async_commit();
            wide_tile_product<T, TR>(
                wide_smem + (size_t)(t % nst) * STAGE, warp * KS,
                ld - t * KT - warp * KS, li, lj, acc_re, acc_im);
        }
        __syncwarp();
        // the next step's first tiles of G, before the barrier
        if (next) {
            for (int t = 0; t < nst - 1 && t < tiles; ++t)
                load_g(step_row(s + 1), t, t);
        }
        cp_async_commit();
#pragma unroll
        for (int rr = 0; rr < TR; ++rr) {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                red[(warp * kSliceRhs + lj + 4 * q) * BR + li + 8 * rr] =
                    make_float2(acc_re[rr][q], acc_im[rr][q]);
        }
        __syncthreads();
#pragma unroll
        for (int o = 0; o < PER_THREAD; ++o) {
            const int idx = threadIdx.x + o * kWideThreads;
            const int rl = idx % BR, cl = idx / BR;
            const int i = row0 + rl, r = rhs0 + cl;
            if (idx >= OUTS || i >= n || r >= R) continue;
            // the warps' partial sums in warp order
            float2 sum = red[cl * BR + rl];
#pragma unroll
            for (int w = 1; w < kWideWarps; ++w) {
                const float2 p = red[(w * kSliceRhs + cl) * BR + rl];
                sum = make_float2(__fadd_rn(sum.x, p.x), __fadd_rn(sum.y, p.y));
            }
            float2 res;
            if (MODE == kFwd) {
                const float2 t = cmul_rn(pc[o], sum);
                res = make_float2(__fsub_rn(pu[o].x, t.x),
                                  __fsub_rn(pu[o].y, t.y));
            } else if (MODE == kBwd) {
                res = sum;
            } else {
                res = make_float2(__fsub_rn(pu[o].x, sum.x),
                                  __fsub_rn(pu[o].y, sum.y));
            }
            a.out[k * rs + (size_t)r * n + i] = res;
            if (next)
                buf[(s + 1) & 1][(size_t)r * ld + i] = (MODE == kFwd)
                    ? res : couple_rn<MODE>(pnu[o], pnc[o], res);
        }
        if (next) all_blocks.sync();
    }
}

// Dynamic shared memory of a wide launch: `stages` ring stages and the
// warps' partial sums.  ops/kernels/sweep.py `wide_plan` computes the same
// number.
size_t wide_shared_bytes(int rows_per_block, int g_bytes, int stages) {
    return (size_t)stages * wide_stage_bytes(rows_per_block, g_bytes)
           + (size_t)kWideWarps * rows_per_block * kSliceRhs * sizeof(float2);
}

// Dynamic shared memory of a launch: the operand and `stages` stages of G.
// ops/kernels/sweep.py `launch_plan` computes the same number.
size_t shared_bytes(int R, size_t g_bytes, bool lerp, int ld,
                    int rows_per_block, int stages) {
    const size_t operand = 2 * (size_t)R * ld * sizeof(float);
    const size_t stage = (size_t)rows_per_block * (lerp ? 2 : 1) * 2 * ld
                         * g_bytes;
    return operand + (size_t)stages * stage;
}

// What a launch asks of the runtime besides the launch itself, kept for
// each kernel instance and device so that a sweep pays it once and not at
// every call: the dynamic shared memory the kernel has been allowed, and
// the blocks the card holds at once at the last (threads, shared memory)
// asked.
struct LaunchCache {
    int allowed_smem = 0;
    int threads = 0;
    size_t smem = 0;
    int resident = 0;
};

std::mutex launch_cache_mutex;

// Allows `kernel` `smem` bytes of dynamic shared memory and sets
// *resident to the blocks of `threads` threads that the current device
// holds at once, asking the runtime only what `cache` does not hold yet.
template <typename Kernel>
cudaError_t prepare_launch(Kernel kernel, std::map<int, LaunchCache>& cache,
                           int threads, size_t smem, int* resident) {
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(launch_cache_mutex);
    LaunchCache& c = cache[device];
    if ((int)smem > c.allowed_smem) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return e;
        c.allowed_smem = (int)smem;
    }
    if (c.threads != threads || c.smem != smem) {
        int sms = 0, per_sm = 0;
        e = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                   device);
        if (e != cudaSuccess) return e;
        e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                          threads, smem);
        if (e != cudaSuccess) return e;
        c.threads = threads;
        c.smem = smem;
        c.resident = sms * per_sm;
    }
    *resident = c.resident;
    return cudaSuccess;
}

// One cooperative launch of `kernel` with the one argument `a`.  Every
// block must be resident at once; the runtime refuses the launch
// otherwise, and so does this check, before it.
template <typename Kernel, typename Args>
int launch_cooperative(Kernel kernel, std::map<int, LaunchCache>& cache,
                       const Args& a, int blocks, int threads, size_t smem,
                       cudaStream_t stream) {
    int resident = 0;
    cudaError_t e = prepare_launch(kernel, cache, threads, smem, &resident);
    if (e != cudaSuccess) return (int)e;
    if (blocks > resident) return (int)cudaErrorCooperativeLaunchTooLarge;
    Args args = a;
    void* params[] = {&args};
    e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                    dim3(blocks), dim3(threads), params, smem,
                                    stream);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}

template <typename T, int MODE, int R, bool LERP, bool TRI>
int run_sweep(const SweepArgs& a, int blocks, cudaStream_t stream) {
    auto kernel = sweep_kernel<T, MODE, R, LERP, TRI>;
    static std::map<int, LaunchCache> cache;
    const size_t smem = shared_bytes(R, sizeof(T), LERP, a.ld,
                                     a.rows_per_block, a.stages);
    if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
    const int threads = 32 * min(a.rows_per_block, kMaxWarps);
    return launch_cooperative(kernel, cache, a, blocks, threads, smem,
                              stream);
}

template <typename T, int MODE, int TR>
int run_sweep_wide(const WideArgs& a, int blocks, cudaStream_t stream) {
    auto kernel = sweep_kernel_wide<T, MODE, TR>;
    static std::map<int, LaunchCache> cache;
    const size_t smem = wide_shared_bytes(8 * TR, sizeof(T), a.stages);
    if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
    return launch_cooperative(kernel, cache, a, blocks, kWideThreads, smem,
                              stream);
}

template <typename T, int MODE>
int dispatch_wide_rows(int rows_per_block, const WideArgs& a, int blocks,
                       cudaStream_t s) {
    switch (rows_per_block) {
        case 8: return run_sweep_wide<T, MODE, 1>(a, blocks, s);
        case 16: return run_sweep_wide<T, MODE, 2>(a, blocks, s);
        case 32: return run_sweep_wide<T, MODE, 4>(a, blocks, s);
        case 64: return run_sweep_wide<T, MODE, 8>(a, blocks, s);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T>
int dispatch_wide(int mode, int rows_per_block, const WideArgs& a,
                  int blocks, cudaStream_t s) {
    switch (mode) {
        case kFwd: return dispatch_wide_rows<T, kFwd>(rows_per_block, a,
                                                      blocks, s);
        case kBwd: return dispatch_wide_rows<T, kBwd>(rows_per_block, a,
                                                      blocks, s);
        case kBwdSub: return dispatch_wide_rows<T, kBwdSub>(rows_per_block, a,
                                                            blocks, s);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, int MODE, bool LERP, bool TRI>
int dispatch_width(int nrhs, const SweepArgs& a, int blocks,
                   cudaStream_t s) {
    switch (nrhs) {
        case 1: return run_sweep<T, MODE, 1, LERP, TRI>(a, blocks, s);
        case 2: return run_sweep<T, MODE, 2, LERP, TRI>(a, blocks, s);
        case 3: return run_sweep<T, MODE, 3, LERP, TRI>(a, blocks, s);
        case 4: return run_sweep<T, MODE, 4, LERP, TRI>(a, blocks, s);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool LERP, bool TRI>
int dispatch_mode(int mode, int nrhs, const SweepArgs& a, int blocks,
                  cudaStream_t s) {
    switch (mode) {
        case kFwd: return dispatch_width<T, kFwd, LERP, TRI>(nrhs, a, blocks, s);
        case kBwd: return dispatch_width<T, kBwd, LERP, TRI>(nrhs, a, blocks, s);
        case kBwdSub:
            return dispatch_width<T, kBwdSub, LERP, TRI>(nrhs, a, blocks, s);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool TRI>
int dispatch_lerp(int mode, int nrhs, const SweepArgs& a, int blocks,
                  cudaStream_t s) {
    return a.g_lo ? dispatch_mode<T, true, TRI>(mode, nrhs, a, blocks, s)
                  : dispatch_mode<T, false, TRI>(mode, nrhs, a, blocks, s);
}

template <typename T>
int dispatch_coupling(int mode, int nrhs, int tri, const SweepArgs& a,
                      int blocks, cudaStream_t s) {
    return tri ? dispatch_lerp<T, true>(mode, nrhs, a, blocks, s)
               : dispatch_lerp<T, false>(mode, nrhs, a, blocks, s);
}

}  // namespace

// mode: 0 fwd, 1 bwd, 2 bwd_sub.  g_bf16: 1 if the planes hold bfloat16,
// 0 for float32.  panel_stride: elements between consecutive panels of a
// plane (0 for one shared panel).  ld: row pitch in elements, a multiple
// of 8.  nrhs: right-hand sides of this call, 1..4.  row_stride: complex
// elements between consecutive steps of u and out (the whole batch's
// R_total * n).  g_lo (S int32, values <= panels - 2) and g_w (S x 2
// float32): device pointers to the lerp tables, or both null.  u, out:
// nrhs rows of n per step; carry0: nrhs rows of n; complex64.  tri: 0 for
// diagonal coupling, c (S, n); 1 for tridiagonal, c (S, 3, n) as [sub,
// diag, sup].  scratch: 2 * nrhs * n complex64 words of device memory that
// the kernel writes and reads in mode 0 with tri = 1 (the raw products)
// and in modes 1 and 2 with tri = 0 (the operands the owners publish);
// otherwise unused and may be null.
// blocks, rows_per_block, stages: the launch plan (ops/kernels/sweep.py
// `launch_plan`): block b owns rows [b * rows_per_block, ...), the blocks
// cover the n rows exactly once, and `stages` stages of G (0, 1 or 2) fit
// the shared memory.  One cooperative launch; returns a CUDA error code
// (0 on success), also when the runtime refuses the launch.
extern "C" int hh_sweep(int mode, int g_bf16, const void* g_re,
                        const void* g_im, long long panel_stride, int ld,
                        int n, int S, int nrhs, long long row_stride,
                        const void* g_lo, const void* g_w, const void* u,
                        const void* c, int tri, const void* carry0,
                        void* out, void* scratch, int blocks,
                        int rows_per_block, int stages, void* stream) {
    if (ld % 8 != 0 || ld < n || n <= 0 || S <= 0 || nrhs < 1
            || nrhs > kMaxRhs || row_stride < (long long)nrhs * n
            || (g_lo == nullptr) != (g_w == nullptr)
            || ((tri != 0) == (mode == kFwd) && scratch == nullptr)
            || rows_per_block < 1 || blocks < 1
            || (long long)blocks * rows_per_block < n
            || (long long)(blocks - 1) * rows_per_block >= n
            || stages < 0 || stages > kMaxStages)
        return (int)cudaErrorInvalidValue;
    const SweepArgs a = {g_re, g_im, panel_stride, ld, n, S, row_stride,
                         (const int*)g_lo, (const float*)g_w,
                         (const float2*)u, (const float2*)c,
                         (const float2*)carry0, (float2*)out,
                         (float2*)scratch, rows_per_block, stages};
    cudaStream_t s = (cudaStream_t)stream;
    if (g_bf16)
        return dispatch_coupling<__nv_bfloat16>(mode, nrhs, tri, a, blocks, s);
    return dispatch_coupling<float>(mode, nrhs, tri, a, blocks, s);
}

// The wide sweep (`sweep_kernel_wide`): dense G (panel_stride between
// panels), diagonal coupling c (S, n), nrhs >= 1 right-hand sides in ONE
// cooperative launch.  mode, g_bf16, g_re, g_im, ld, n, S, row_stride, u,
// c, carry0, out as for hh_sweep.  scratch: 2 * nrhs * ld complex64 words
// of device memory, pad columns [n, ld) of every row zero (the kernel
// writes only columns below n).  row_groups, rows_per_block (8, 16, 32 or
// 64), slices, stages (2..4): the launch plan (ops/kernels/sweep.py
// `wide_plan`): the row groups cover the n rows exactly once, the slices
// of 16 the nrhs right-hand sides, and the grid is row_groups * slices
// blocks.  Returns a CUDA error code (0 on success), also when the runtime
// refuses the launch.
extern "C" int hh_sweep_wide(int mode, int g_bf16, const void* g_re,
                             const void* g_im, long long panel_stride, int ld,
                             int n, int S, int nrhs, long long row_stride,
                             const void* u, const void* c, const void* carry0,
                             void* out, void* scratch, int row_groups,
                             int rows_per_block, int slices, int stages,
                             void* stream) {
    if (ld % 8 != 0 || ld < n || n <= 0 || S <= 0 || nrhs < 1
            || row_stride < (long long)nrhs * n || scratch == nullptr
            || row_groups < 1 || (long long)row_groups * rows_per_block < n
            || (long long)(row_groups - 1) * rows_per_block >= n
            || slices < 1 || (long long)slices * kSliceRhs < nrhs
            || (long long)(slices - 1) * kSliceRhs >= nrhs
            || stages < kWideMinStages || stages > kWideMaxStages)
        return (int)cudaErrorInvalidValue;
    const WideArgs a = {g_re, g_im, panel_stride, ld, n, S, nrhs, row_stride,
                        (const float2*)u, (const float2*)c,
                        (const float2*)carry0, (float2*)out,
                        (float2*)scratch, row_groups, stages};
    const int blocks = row_groups * slices;
    cudaStream_t s = (cudaStream_t)stream;
    if (g_bf16)
        return dispatch_wide<__nv_bfloat16>(mode, rows_per_block, a, blocks,
                                            s);
    return dispatch_wide<float>(mode, rows_per_block, a, blocks, s);
}
