// Batched unpivoted complex Gauss-Jordan inverse of small panels, for sm_90a.
//
// Replaces the TPU kernel `_kernel` / `pallas_gj_inverse` of
// helmholtz_tpu/ops/pallas/gj_inverse.py: the base case of the blocked
// Gauss-Jordan inverse (ops/dense.py `_blocked_gj`) that the preconditioner
// setup runs on every Schur complement.  It computes, for each (k, k)
// complex matrix X of a batch, k rank-1 elimination steps j = 0..k-1:
//
//     p = X[j, j]
//     X[r, c] -= X[r, j] * X[j, c] / p      (r != j, c != j)
//     X[r, j]  = -X[r, j] / p               (r != j)
//     X[j, c]  =  X[j, c] / p               (c != j)
//     X[j, j]  =  1 / p
//
// which leaves X^{-1} in place.  No pivoting, as on the TPU: the Schur
// complements are complex-shifted, PML-damped blocks with dominant
// diagonals.
//
// Bound: operations.  A step is k^2 complex multiply-subtracts, 8 k^3
// float32 operations a matrix on the CUDA cores, against 16 k^2 bytes (the
// matrix read once, the inverse written once).
//
// Design: one block per matrix.  The whole panel sits in dynamic shared
// memory as interleaved complex float32 (32 KB at k = 64, 128 KB at
// k = 128), so the k steps touch device memory only to load it and store
// the result, as the TPU kernel keeps its panel in VMEM.  Each step first
// copies column j and row j / p into shared vectors (every thread reads the
// pivot before any element changes, and `inv_pivot` is the one place that
// takes its reciprocal), synchronises, lets every thread update its own
// elements from those vectors, and synchronises again.  The grid is the
// batch: no padding with identities is needed.  At a batch of one (the
// exact factorization's layer inverses) one block runs alone on the card.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxK = 128;

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 inv_pivot(float2 p) {
    const float d = p.x * p.x + p.y * p.y;
    return make_float2(p.x / d, -p.y / d);
}

__global__ void __launch_bounds__(kThreads)
gj_inverse_kernel(const float2* __restrict__ a, float2* __restrict__ out,
                  int k) {
    extern __shared__ float2 smem[];
    float2* X = smem;                 // (k, k), row-major
    float2* col = X + k * k;          // column j before the step
    float2* prow = col + k;           // row j times 1/p
    const int kk = k * k;
    const long long base = (long long)blockIdx.x * kk;

    for (int e = threadIdx.x; e < kk; e += kThreads) X[e] = a[base + e];
    __syncthreads();

    for (int j = 0; j < k; ++j) {
        const float2 ip = inv_pivot(X[j * k + j]);
        for (int i = threadIdx.x; i < k; i += kThreads) {
            col[i] = X[i * k + j];
            prow[i] = cmul(X[j * k + i], ip);
        }
        __syncthreads();
        for (int e = threadIdx.x; e < kk; e += kThreads) {
            const int r = e / k;
            const int c = e - r * k;
            float2 v;
            if (r == j) {
                v = c == j ? ip : prow[c];
            } else if (c == j) {
                const float2 t = cmul(col[r], ip);
                v = make_float2(-t.x, -t.y);
            } else {
                const float2 cr = col[r];
                const float2 pc = prow[c];
                v = X[e];
                v.x = fmaf(-cr.x, pc.x, v.x);
                v.x = fmaf(cr.y, pc.y, v.x);
                v.y = fmaf(-cr.x, pc.y, v.y);
                v.y = fmaf(-cr.y, pc.x, v.y);
            }
            X[e] = v;
        }
        __syncthreads();
    }

    for (int e = threadIdx.x; e < kk; e += kThreads) out[base + e] = X[e];
}

}  // namespace

// a, out: (batch, k, k) complex64, contiguous; 1 <= k <= 128.  Returns a
// CUDA error code (0 on success).
extern "C" int hh_gj_inverse(const void* a, void* out, int batch, int k,
                             void* stream) {
    if (k < 1 || k > kMaxK || batch < 1) return (int)cudaErrorInvalidValue;
    const size_t smem = (size_t)(k * k + 2 * k) * sizeof(float2);
    if (smem > 48 * 1024) {
        cudaError_t e = cudaFuncSetAttribute(
            gj_inverse_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            (int)smem);
        if (e != cudaSuccess) return (int)e;
    }
    gj_inverse_kernel<<<batch, kThreads, smem, (cudaStream_t)stream>>>(
        (const float2*)a, (float2*)out, k);
    return (int)cudaGetLastError();
}
