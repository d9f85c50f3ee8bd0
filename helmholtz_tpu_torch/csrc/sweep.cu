// Sweep recursion of the moving-PML preconditioner over the corner-inverse
// stack G, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of helmholtz_tpu/ops/pallas/sweep.py
// (wrapper `pallas_sweep`), in the modes the single-RHS 5-point solve runs:
//   fwd     : out[k] = u[k] - c[k] * (G[k] @ prev),  prev = carry0 | out[k-1]
//   bwd     : out[j] = G[j] @ (u[j] - c[j] * next),  next = carry0 | out[j+1]
//   bwd_sub : out[j] = u[j] - G[j] @ (u[j] + c[j] * next)
// with diagonal coupling c, one right-hand side, G stored as two real
// planes (re, im) in float32 or bfloat16, and optionally ONE shared panel
// (panel stride 0).  The TPU kernel is a sequential grid that keeps its
// carry in persistent scratch and reads G in 128-lane padded tiles; here
// blocks run in parallel and nothing persists between them, so the
// recursion is ordered differently.
//
// Bound: bytes.  Every step is a dense complex GEMV of one n x n panel
// (8 flops per 4 B of bf16 G, or per 8 B of f32 G) against a vector that
// depends on the step before, so the panel stream from device memory is
// the limit.  One block cannot pull a panel at device-memory rate, hence:
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
// Each lane loads 16 bytes of a row at a time (8 bf16 or 4 f32 values), so
// a row must start 16-byte aligned: the planes are (Mg, n, ld) with row
// pitch ld = ceil(n / 8) * 8 elements (1024 at n = 1023) and zero pad
// columns.  The vector operand lives in shared memory as float32, zero
// padded to ld.
//
// Precision: a bf16 G value is widened to float32 in registers and
// multiplied by the float32 vector with float32 FMA, which is exact for
// the product.  The hi+lo bf16 split of the carry that the TPU kernel
// needs for its bf16 matrix unit is therefore not needed here; it would
// return only if the product moved to the tensor cores.  float32 G uses
// plain float32 FMA (no TF32 anywhere).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kWarpsPerBlock = 4;
constexpr int kThreads = kWarpsPerBlock * 32;

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

// One step.  Shared memory: vr[ld], vi[ld] = the vector the panel is
// multiplied with.  `other` is prev (fwd) or next (bwd, bwd_sub).
template <typename T, int MODE>
__global__ void __launch_bounds__(kThreads)
sweep_step_kernel(const T* __restrict__ g_re, const T* __restrict__ g_im,
                  const float2* __restrict__ u, const float2* __restrict__ c,
                  const float2* other, float2* out, int n, int ld) {
    extern __shared__ __align__(16) float smem[];
    float* vr = smem;
    float* vi = smem + ld;

    for (int i = threadIdx.x; i < ld; i += kThreads) {
        float2 v = make_float2(0.f, 0.f);
        if (i < n) {
            const float2 o = other[i];
            if (MODE == kFwd) {
                v = o;
            } else {
                const float2 ci = c[i];
                const float2 ui = u[i];
                const float pr = ci.x * o.x - ci.y * o.y;
                const float pi = ci.x * o.y + ci.y * o.x;
                v = (MODE == kBwd) ? make_float2(ui.x - pr, ui.y - pi)
                                   : make_float2(ui.x + pr, ui.y + pi);
            }
        }
        vr[i] = v.x;
        vi[i] = v.y;
    }
    __syncthreads();

    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const int row = blockIdx.x * kWarpsPerBlock + warp;
    if (row >= n) return;

    constexpr int E = Vec16<T>::kElems;
    const T* pr_row = g_re + (size_t)row * ld;
    const T* pi_row = g_im + (size_t)row * ld;
    float acc_re = 0.f, acc_im = 0.f;
#pragma unroll 4
    for (int col = lane * E; col < ld; col += 32 * E) {
        float gr[E], gi[E];
        Vec16<T>::load(pr_row + col, gr);
        Vec16<T>::load(pi_row + col, gi);
#pragma unroll
        for (int q = 0; q < E; q += 4) {
            // 16-byte shared loads: col is a multiple of 4 and ld of 8
            const float4 a = *reinterpret_cast<const float4*>(vr + col + q);
            const float4 b = *reinterpret_cast<const float4*>(vi + col + q);
            const float xr[4] = {a.x, a.y, a.z, a.w};
            const float xi[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
            for (int t = 0; t < 4; ++t) {
                acc_re = fmaf(gr[q + t], xr[t], acc_re);
                acc_re = fmaf(-gi[q + t], xi[t], acc_re);
                acc_im = fmaf(gr[q + t], xi[t], acc_im);
                acc_im = fmaf(gi[q + t], xr[t], acc_im);
            }
        }
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        acc_re += __shfl_xor_sync(0xffffffffu, acc_re, off);
        acc_im += __shfl_xor_sync(0xffffffffu, acc_im, off);
    }
    if (lane == 0) {
        float2 res;
        if (MODE == kFwd) {
            const float2 ci = c[row];
            const float2 ui = u[row];
            res.x = ui.x - (ci.x * acc_re - ci.y * acc_im);
            res.y = ui.y - (ci.x * acc_im + ci.y * acc_re);
        } else if (MODE == kBwd) {
            res = make_float2(acc_re, acc_im);
        } else {
            const float2 ui = u[row];
            res = make_float2(ui.x - acc_re, ui.y - acc_im);
        }
        out[row] = res;
    }
}

template <typename T, int MODE>
int run_sweep(const T* g_re, const T* g_im, long long panel_stride, int ld,
              int n, int S, const float2* u, const float2* c,
              const float2* carry0, float2* out, cudaStream_t stream) {
    const int blocks = (n + kWarpsPerBlock - 1) / kWarpsPerBlock;
    const size_t smem = 2 * (size_t)ld * sizeof(float);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            sweep_step_kernel<T, MODE>,
            cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    for (int s = 0; s < S; ++s) {
        // fwd walks rows first to last, the backward modes last to first;
        // step row k uses panel k (or the one shared panel)
        const int k = (MODE == kFwd) ? s : S - 1 - s;
        const float2* other;
        if (s == 0) {
            other = carry0;
        } else {
            other = out + (size_t)((MODE == kFwd) ? k - 1 : k + 1) * n;
        }
        const size_t row_off = (size_t)k * n;
        sweep_step_kernel<T, MODE><<<blocks, kThreads, smem, stream>>>(
            g_re + (size_t)k * panel_stride, g_im + (size_t)k * panel_stride,
            u + row_off, c + row_off, other, out + row_off, n, ld);
    }
    return (int)cudaGetLastError();
}

template <typename T>
int dispatch_mode(int mode, const void* g_re, const void* g_im,
                  long long panel_stride, int ld, int n, int S,
                  const void* u, const void* c, const void* carry0,
                  void* out, cudaStream_t stream) {
    const T* gr = (const T*)g_re;
    const T* gi = (const T*)g_im;
    const float2* uu = (const float2*)u;
    const float2* cc = (const float2*)c;
    const float2* c0 = (const float2*)carry0;
    float2* oo = (float2*)out;
    switch (mode) {
        case kFwd:
            return run_sweep<T, kFwd>(gr, gi, panel_stride, ld, n, S, uu, cc,
                                      c0, oo, stream);
        case kBwd:
            return run_sweep<T, kBwd>(gr, gi, panel_stride, ld, n, S, uu, cc,
                                      c0, oo, stream);
        case kBwdSub:
            return run_sweep<T, kBwdSub>(gr, gi, panel_stride, ld, n, S, uu,
                                         cc, c0, oo, stream);
    }
    return (int)cudaErrorInvalidValue;
}

}  // namespace

// mode: 0 fwd, 1 bwd, 2 bwd_sub.  g_bf16: 1 if the planes hold bfloat16,
// 0 for float32.  panel_stride: elements between consecutive panels of a
// plane (0 for one shared panel).  ld: row pitch in elements, a multiple
// of 8.  u, c, out: (S, n) complex64; carry0: (n,) complex64.
extern "C" int hh_sweep(int mode, int g_bf16, const void* g_re,
                        const void* g_im, long long panel_stride, int ld,
                        int n, int S, const void* u, const void* c,
                        const void* carry0, void* out, void* stream) {
    if (ld % 8 != 0 || ld < n || n <= 0 || S <= 0)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (g_bf16)
        return dispatch_mode<__nv_bfloat16>(mode, g_re, g_im, panel_stride,
                                            ld, n, S, u, c, carry0, out, st);
    return dispatch_mode<float>(mode, g_re, g_im, panel_stride, ld, n, S, u,
                                c, carry0, out, st);
}
