// Sweep recursion of the moving-PML preconditioner over the corner-inverse
// stack G, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of helmholtz_tpu/ops/pallas/sweep.py
// (wrapper `pallas_sweep`), in all its modes:
//   fwd     : out[k] = u[k] - c[k] * (G[k] @ prev),  prev = carry0 | out[k-1]
//   bwd     : out[j] = G[j] @ (u[j] - c[j] * next),  next = carry0 | out[j+1]
//   bwd_sub : out[j] = u[j] - G[j] @ (u[j] + c[j] * next)
// with the coupling c shared by R right-hand sides (R = 1..4 per launch), G
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
// scratch and reads G in 128-lane padded tiles; here blocks run in parallel
// and nothing persists between them, so the recursion is ordered
// differently.
//
// Bound: bytes.  Every step is a dense complex product of one n x n panel
// (8 flops per right-hand side per 4 B of bf16 G, or per 8 B of f32 G)
// against R vectors that depend on the step before, so the panel stream
// from device memory is the limit up to about R = 10 (bf16) or 20 (f32) at
// 67 TFLOP/s of float32 FMA.  One block cannot pull a panel at
// device-memory rate, hence:
//   * the rows of a panel are split over many blocks, one warp per row, so
//     the row sum needs no reduction across blocks;
//   * steps are ordered by launching ONE KERNEL PER STEP on the caller's
//     stream; the entry point below loops over the steps itself, so the
//     host makes one call per sweep.
// At n = 1023 a step moves 4.2 MB (bf16), about 1.3 us at 3.35 TB/s, which
// is less than a kernel launch: this design is launch-bound, far from the
// byte bound.  The follow-up is a persistent cooperative kernel with a grid
// barrier per step, or a CUDA graph of the step launches.
//
// R > 1: a lane loads its 16 bytes of the G row ONCE and multiplies them
// into R pairs of accumulators, so R solves ride one stream of G.  The
// operand in shared memory is 2 * R * ld floats (32 KB at R = 4,
// ld = 1024).  The coupling prologue and the epilogue run per right-hand
// side with the shared c.
//
// A step is latency-bound, so both phases of the kernel start their global
// loads in batches before they use any of them.
//
// lerp: a warp takes its row's dot product against panel lo[k] and against
// panel lo[k] + 1 and combines the two sums as w0 * acc0 + w1 * acc1 in
// float32, on the outputs, as the TPU kernel does.  Every block reads its
// own lo[k] and weights from device memory; nothing goes through the host.
// The least traffic is each sample panel once a sweep; with no reuse it is
// two panels a step.  Consecutive steps share their pair of panels
// (stride - 1 times out of stride), and two bf16 panels at n = 1023 are
// 8.4 MB against 50 MB of L2, so the second figure is not a lower bound on
// this card; which one this kernel lands near is a measurement.  The
// function itself, (w0 G[lo] + w1 G[lo+1]) @ V, needs one combine of the two
// panels and ONE product, (8 R + 6) n^2 operations a step, and its bound
// counts that; this kernel spends two products a step (16 R n^2) to keep
// the weights on the outputs.  At n = 1023 with bf16 samples the operations
// (0.22 ms a sweep at R = 1, 0.60 ms at R = 4) pass the least traffic
// (0.19 ms), so operations bind the function.
//
// Tridiagonal coupling.  In bwd / bwd_sub the coupling acts on `other`,
// which every block reads whole in its prologue anyway: element i takes
// other[i-1], other[i], other[i+1] and three coefficient rows.  In fwd it
// acts on the PRODUCT w = G[k] @ prev, whose neighbouring rows belong to
// other warps and, at a block's edge, to other blocks (the TPU kernel holds
// all of w in scratch and rolls lanes; nothing carries across blocks here).
// Chosen: the fwd step stores the RAW product w_k into one of two small
// scratch rows (ping-pong: a step's blocks read w_{k-1} while others write
// w_k), and the NEXT step's prologue, which reads the whole vector anyway,
// forms prev = out[k] = u[k] - c[k] w_k; the block that owns rows
// 4 b .. 4 b + 3 also stores those elements of out[k].  One small tail
// kernel forms the last row.  So G is still read once a step, a sweep is
// S + 1 launches instead of S, and every sum has a fixed order.  Not
// chosen: a coupling kernel after every step (2 S launches of a
// launch-bound sweep), float atomics (order changes run to run), or
// recomputing the neighbour rows (three times the stream of G).
// Assembly zeroes sub[0] and sup[n-1], but the kernel does not lean on it:
// it never reads index -1 or n (with R > 1 those are the neighbouring
// right-hand side's memory), so those two slots are ignored whatever they
// hold, as the plain version's shifted slices ignore them.
//
// Each lane loads 16 bytes of a row at a time (8 bf16 or 4 f32 values), so
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
// plain float32 FMA (no TF32 anywhere).  A right-hand side's sums are taken
// in the same order whatever R it is launched with.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;
constexpr int kMaxRhs = 4;
constexpr size_t kMaxSharedBytes = 232448;   // 227 KB, the most a block gets

enum Mode { kFwd = 0, kBwd = 1, kBwdSub = 2 };

template <typename T>
struct Vec16;

template <>
struct Vec16<float> {
    static constexpr int kElems = 4;
    __device__ static void load(const float* p, float (&v)[4]) {
        const float4 q = __ldg(reinterpret_cast<const float4*>(p));
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
    }
};

template <>
struct Vec16<__nv_bfloat16> {
    static constexpr int kElems = 8;
    __device__ static void load(const __nv_bfloat16* p, float (&v)[8]) {
        const uint4 q = __ldg(reinterpret_cast<const uint4*>(p));
        const unsigned int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int t = 0; t < 4; ++t) {
            // a bf16 is the upper half of a float32
            v[2 * t] = __uint_as_float(w[t] << 16);
            v[2 * t + 1] = __uint_as_float(w[t] & 0xffff0000u);
        }
    }
};

// What one sweep is given.  u, out: (S, R_total, n) complex64 with
// `row_stride` = R_total * n elements between steps; this launch handles R
// consecutive right-hand sides starting where the pointers point.
// c: (S, n), or (S, 3, n) when `tri`.  carry0: R rows of n.  g_lo, g_w: the
// lerp tables, or null.  scratch: 2 * R * n complex words, for fwd with tri.
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
    cudaStream_t stream;
};

__device__ __forceinline__ float2 cmul_add(float2 a, float2 b, float2 acc) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
    return acc;
}

// Prologue of a step with diagonal coupling: fills the shared operand with
// other (fwd), u - c * other (bwd) or u + c * other (bwd_sub).
template <int MODE, int R>
__device__ __forceinline__ void diag_prologue(
        float* vr, float* vi, const float2* __restrict__ u,
        const float2* __restrict__ c, const float2* other, int n, int ld) {
    // Loads first, uses after: a thread fetches kBatch elements of every
    // stream before it combines any, so their latencies overlap (left to
    // itself the compiler chained them: load, combine, load).  Elements
    // past n load nothing and combine to the zero padding.
    constexpr int kBatch = 4;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        for (int base = threadIdx.x; base < ld; base += kBatch * kThreads) {
            float2 o[kBatch], ci[kBatch], ui[kBatch];
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
                const int i = base + j * kThreads;
                o[j] = ci[j] = ui[j] = make_float2(0.f, 0.f);
                if (i < n) {
                    o[j] = other[r * n + i];
                    if (MODE != kFwd) {
                        ci[j] = c[i];
                        ui[j] = u[r * n + i];
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
                const int i = base + j * kThreads;
                if (i < ld) {
                    float2 v = o[j];
                    if (MODE != kFwd) {
                        const float pr = ci[j].x * o[j].x - ci[j].y * o[j].y;
                        const float pi = ci[j].x * o[j].y + ci[j].y * o[j].x;
                        v = (MODE == kBwd)
                            ? make_float2(ui[j].x - pr, ui[j].y - pi)
                            : make_float2(ui[j].x + pr, ui[j].y + pi);
                    }
                    vr[r * ld + i] = v.x;
                    vi[r * ld + i] = v.y;
                }
            }
        }
    }
}

// Prologue of a step with tridiagonal coupling: fills the shared operand
//   v = base -+ c x,   c = [sub, diag, sup] rows of n,
// for R right-hand sides.  bwd / bwd_sub: base = u[k], x = next, sign - / +.
// fwd: base = u[k-1], x = the raw product w_{k-1} of the step before, sign -,
// so v = out[k-1] = prev, and the block stores the elements of its own rows
// to `store`; at the first step (`first`) v is x = carry0 as it is.
// Loads first, uses after, as in the kernel below.  x[i-1] and x[i+1] are
// read only inside 0..n-1.
template <int MODE, int R>
__device__ __forceinline__ void tri_prologue(
        float* vr, float* vi, const float2* __restrict__ base,
        const float2* __restrict__ c, const float2* x, float2* store,
        bool first, int n, int ld) {
    constexpr int kBatch = 4;
#pragma unroll
    for (int r = 0; r < R; ++r) {
        for (int i0 = threadIdx.x; i0 < ld; i0 += kBatch * kThreads) {
            float2 xm[kBatch], x0[kBatch], xp[kBatch];
            float2 sub[kBatch], dia[kBatch], sup[kBatch], bs[kBatch];
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
                const int i = i0 + j * kThreads;
                const float2 zero = make_float2(0.f, 0.f);
                xm[j] = x0[j] = xp[j] = sub[j] = dia[j] = sup[j] = bs[j] = zero;
                if (i < n) {
                    x0[j] = x[r * n + i];
                    if (!first) {
                        if (i > 0) {
                            xm[j] = x[r * n + i - 1];
                            sub[j] = c[i];
                        }
                        if (i + 1 < n) {
                            xp[j] = x[r * n + i + 1];
                            sup[j] = c[2 * n + i];
                        }
                        dia[j] = c[n + i];
                        bs[j] = base[r * n + i];
                    }
                }
            }
#pragma unroll
            for (int j = 0; j < kBatch; ++j) {
                const int i = i0 + j * kThreads;
                if (i < ld) {
                    float2 v = x0[j];
                    if (!first) {
                        float2 t = make_float2(0.f, 0.f);
                        t = cmul_add(sub[j], xm[j], t);
                        t = cmul_add(dia[j], x0[j], t);
                        t = cmul_add(sup[j], xp[j], t);
                        v = (MODE == kBwdSub)
                            ? make_float2(bs[j].x + t.x, bs[j].y + t.y)
                            : make_float2(bs[j].x - t.x, bs[j].y - t.y);
                        if (MODE == kFwd && i < n
                                && i / kWarpsPerBlock == (int)blockIdx.x)
                            store[r * n + i] = v;
                    }
                    vr[r * ld + i] = v.x;
                    vi[r * ld + i] = v.y;
                }
            }
        }
    }
}

// The last row of a fwd sweep with tridiagonal coupling:
// out = u - c w for `nrhs` right-hand sides, one thread per element.
__global__ void __launch_bounds__(kThreads)
sweep_tri_tail_kernel(const float2* __restrict__ u,
                      const float2* __restrict__ c,
                      const float2* __restrict__ w, float2* out, int n,
                      int nrhs) {
    const int idx = blockIdx.x * kThreads + threadIdx.x;
    if (idx >= nrhs * n) return;
    const int r = idx / n, i = idx - r * n;
    float2 t = make_float2(0.f, 0.f);
    if (i > 0) t = cmul_add(c[i], w[r * n + i - 1], t);
    t = cmul_add(c[n + i], w[r * n + i], t);
    if (i + 1 < n) t = cmul_add(c[2 * n + i], w[r * n + i + 1], t);
    const float2 ui = u[idx];
    out[idx] = make_float2(ui.x - t.x, ui.y - t.y);
}

// One step, logical index k.  Shared memory: vr[R][ld], vi[R][ld] = the
// vectors the panel is multiplied with.  `other` is prev (fwd) or next
// (bwd, bwd_sub); u, other and out point at the step's first right-hand
// side, the r-th one lies r * n further on.  With TRI, c points at the
// step's three rows; in fwd mode u, c and out are those of the step BEFORE,
// `other` is its raw product (carry0 at the first step, `first`), and this
// step's raw product goes to `raw` (see tri_prologue).
template <typename T, int MODE, int R, bool LERP, bool TRI>
__global__ void __launch_bounds__(kThreads)
sweep_step_kernel(const T* __restrict__ g_re, const T* __restrict__ g_im,
                  long long panel_stride, int k,
                  const int* __restrict__ g_lo,
                  const float* __restrict__ g_w,
                  const float2* __restrict__ u, const float2* __restrict__ c,
                  const float2* other, float2* out, float2* raw, int first,
                  int n, int ld) {
    extern __shared__ __align__(16) float smem[];
    float* vr = smem;
    float* vi = smem + R * ld;

    if (TRI) {
        tri_prologue<MODE, R>(vr, vi, u, c, other, out,
                              MODE == kFwd && first != 0, n, ld);
    } else {
        diag_prologue<MODE, R>(vr, vi, u, c, other, n, ld);
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + warp;
    if (row >= n) return;

    constexpr int E = Vec16<T>::kElems;
    constexpr int P = LERP ? 2 : 1;     // panels read per step
    const long long panel = LERP ? g_lo[k] : k;
    const size_t row_off = (size_t)panel * panel_stride + (size_t)row * ld;
    const T* pr_row[P];
    const T* pi_row[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
        pr_row[p] = g_re + row_off + (size_t)p * panel_stride;
        pi_row[p] = g_im + row_off + (size_t)p * panel_stride;
    }
    float acc_re[P][R], acc_im[P][R];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
        for (int r = 0; r < R; ++r) acc_re[p][r] = acc_im[p][r] = 0.f;
    }
    // Again loads first.  float32 planes: kChunks 16-byte pieces of each
    // plane's row (64 registers of G) are in flight before the first is
    // multiplied.  bfloat16 planes: one piece at a time, the loop unrolled
    // and the loads left to the compiler, which measured faster for them.
    constexpr bool kWide = sizeof(T) == 4;
    constexpr int kChunks = kWide ? 32 / (P * E) : 1;
    constexpr int kUnroll = kWide ? 1 : ((R == 1 && !LERP) ? 4 : 2);
#pragma unroll (kUnroll)
    for (int col0 = lane * E; col0 < ld; col0 += kChunks * 32 * E) {
        float gr[kChunks][P][E], gi[kChunks][P][E];
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
            const int col = col0 + ch * 32 * E;
            if (col < ld) {
#pragma unroll
                for (int p = 0; p < P; ++p) {
                    Vec16<T>::load(pr_row[p] + col, gr[ch][p]);
                    Vec16<T>::load(pi_row[p] + col, gi[ch][p]);
                }
            }
        }
#pragma unroll
        for (int ch = 0; ch < kChunks; ++ch) {
            const int col = col0 + ch * 32 * E;
            if (col >= ld) break;
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
                            const float g_r = gr[ch][p][q + t];
                            const float g_i = gi[ch][p][q + t];
                            acc_re[p][r] = fmaf(g_r, xr[t], acc_re[p][r]);
                            acc_re[p][r] = fmaf(-g_i, xi[t], acc_re[p][r]);
                            acc_im[p][r] = fmaf(g_r, xi[t], acc_im[p][r]);
                            acc_im[p][r] = fmaf(g_i, xr[t], acc_im[p][r]);
                        }
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
    float w0 = 1.f, w1 = 0.f;
    if (LERP) {
        w0 = g_w[2 * k];
        w1 = g_w[2 * k + 1];
    }
    // every lane holds every sum; lane r finishes right-hand side r
#pragma unroll
    for (int r = 0; r < R; ++r) {
        if (lane != r) continue;
        float sr = acc_re[0][r], si = acc_im[0][r];
        if (LERP) {
            sr = w0 * sr + w1 * acc_re[P - 1][r];
            si = w0 * si + w1 * acc_im[P - 1][r];
        }
        float2 res;
        if (MODE == kFwd && TRI) {
            raw[r * n + row] = make_float2(sr, si);
            continue;
        } else if (MODE == kFwd) {
            const float2 ci = c[row];
            const float2 ui = u[r * n + row];
            res.x = ui.x - (ci.x * sr - ci.y * si);
            res.y = ui.y - (ci.x * si + ci.y * sr);
        } else if (MODE == kBwd) {
            res = make_float2(sr, si);
        } else {
            const float2 ui = u[r * n + row];
            res = make_float2(ui.x - sr, ui.y - si);
        }
        out[r * n + row] = res;
    }
}

template <typename T, int MODE, int R, bool LERP, bool TRI>
int run_sweep(const SweepArgs& a) {
    const T* g_re = (const T*)a.g_re;
    const T* g_im = (const T*)a.g_im;
    const int blocks = (a.n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = 2 * (size_t)R * a.ld * sizeof(float);
    if (smem > kMaxSharedBytes) return (int)cudaErrorInvalidValue;
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            sweep_step_kernel<T, MODE, R, LERP, TRI>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    const size_t c_stride = (size_t)(TRI ? 3 : 1) * a.n;
    // fwd with tridiagonal coupling: step k leaves its raw product in
    // scratch row k % 2 and finishes row k - 1 (see the note at the top)
    constexpr bool kDeferred = TRI && MODE == kFwd;
    float2* raw[2] = {a.scratch,
                      kDeferred ? a.scratch + (size_t)R * a.n : nullptr};
    for (int s = 0; s < a.S; ++s) {
        // fwd walks rows first to last, the backward modes last to first;
        // step row k uses panel k (dense), the one shared panel, or the
        // pair of sample panels that the tables name for k (lerp)
        const int k = (MODE == kFwd) ? s : a.S - 1 - s;
        // the row whose u, c and out the kernel is handed
        const int row = (kDeferred && s > 0) ? k - 1 : k;
        const float2* other;
        if (s == 0) {
            other = a.carry0;
        } else if (kDeferred) {
            other = raw[(k - 1) % 2];
        } else {
            other = a.out + (size_t)((MODE == kFwd) ? k - 1 : k + 1)
                                * a.row_stride;
        }
        const size_t row_off = (size_t)row * a.row_stride;
        sweep_step_kernel<T, MODE, R, LERP, TRI>
            <<<blocks, kThreads, smem, a.stream>>>(
                g_re, g_im, a.panel_stride, k, a.g_lo, a.g_w, a.u + row_off,
                a.c + (size_t)row * c_stride, other, a.out + row_off,
                kDeferred ? raw[k % 2] : nullptr, s == 0, a.n, a.ld);
    }
    if (kDeferred) {
        const int last = a.S - 1;
        const size_t row_off = (size_t)last * a.row_stride;
        sweep_tri_tail_kernel
            <<<(R * a.n + kThreads - 1) / kThreads, kThreads, 0, a.stream>>>(
                a.u + row_off, a.c + (size_t)last * c_stride, raw[last % 2],
                a.out + row_off, a.n, R);
    }
    return (int)cudaGetLastError();
}

template <typename T, int MODE, bool LERP, bool TRI>
int dispatch_width(int nrhs, const SweepArgs& a) {
    switch (nrhs) {
        case 1: return run_sweep<T, MODE, 1, LERP, TRI>(a);
        case 2: return run_sweep<T, MODE, 2, LERP, TRI>(a);
        case 3: return run_sweep<T, MODE, 3, LERP, TRI>(a);
        case 4: return run_sweep<T, MODE, 4, LERP, TRI>(a);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool LERP, bool TRI>
int dispatch_mode(int mode, int nrhs, const SweepArgs& a) {
    switch (mode) {
        case kFwd: return dispatch_width<T, kFwd, LERP, TRI>(nrhs, a);
        case kBwd: return dispatch_width<T, kBwd, LERP, TRI>(nrhs, a);
        case kBwdSub: return dispatch_width<T, kBwdSub, LERP, TRI>(nrhs, a);
    }
    return (int)cudaErrorInvalidValue;
}

template <typename T, bool TRI>
int dispatch_lerp(int mode, int nrhs, const SweepArgs& a) {
    return a.g_lo ? dispatch_mode<T, true, TRI>(mode, nrhs, a)
                  : dispatch_mode<T, false, TRI>(mode, nrhs, a);
}

template <typename T>
int dispatch_coupling(int mode, int nrhs, int tri, const SweepArgs& a) {
    return tri ? dispatch_lerp<T, true>(mode, nrhs, a)
               : dispatch_lerp<T, false>(mode, nrhs, a);
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
// mode 0 with tri = 1 writes and reads; otherwise unused and may be null.
extern "C" int hh_sweep(int mode, int g_bf16, const void* g_re,
                        const void* g_im, long long panel_stride, int ld,
                        int n, int S, int nrhs, long long row_stride,
                        const void* g_lo, const void* g_w, const void* u,
                        const void* c, int tri, const void* carry0,
                        void* out, void* scratch, void* stream) {
    if (ld % 8 != 0 || ld < n || n <= 0 || S <= 0 || nrhs < 1
            || nrhs > kMaxRhs || row_stride < (long long)nrhs * n
            || (g_lo == nullptr) != (g_w == nullptr)
            || (tri && mode == kFwd && scratch == nullptr))
        return (int)cudaErrorInvalidValue;
    const SweepArgs a = {g_re, g_im, panel_stride, ld, n, S, row_stride,
                         (const int*)g_lo, (const float*)g_w,
                         (const float2*)u, (const float2*)c,
                         (const float2*)carry0, (float2*)out,
                         (float2*)scratch, (cudaStream_t)stream};
    if (g_bf16) return dispatch_coupling<__nv_bfloat16>(mode, nrhs, tri, a);
    return dispatch_coupling<float>(mode, nrhs, tri, a);
}
