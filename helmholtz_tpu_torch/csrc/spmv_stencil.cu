// Complex 5-point stencil matrix-vector product, y = A u, for sm_90a.
//
// Replaces the TPU kernel `_kernel` of helmholtz_tpu/ops/pallas/
// spmv_stencil.py (wrapper `pallas_stencil_matvec`).  That kernel is shaped
// by the TPU: split re/im planes, (8,128) tiles, lane rolls and a DMA'd
// (bl+8)-row halo window.  None of it is carried over.
//
// Bound: bytes.  Each point reads five complex64 coefficients and u once
// and writes y once: 56 B per point, against 5 complex multiply-adds
// (40 flops), so device memory is the limit by two orders of magnitude.
// Design: one thread per grid point, threads of a warp on neighbouring
// points of one row, so every coefficient and u load is a coalesced 8-byte
// access.  The four neighbour reads of u are served by L1/L2 (each u value
// is touched by five threads of nearby rows); shared-memory tiling is left
// for a later change.  Neighbours are bounds-checked instead of padded, so
// any L and n work, odd ones included.
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float2 cfma(float2 a, float2 b, float2 acc) {
    acc.x = fmaf(a.x, b.x, acc.x);
    acc.x = fmaf(-a.y, b.y, acc.x);
    acc.y = fmaf(a.x, b.y, acc.y);
    acc.y = fmaf(a.y, b.x, acc.y);
    return acc;
}

constexpr int kBlockX = 128;
constexpr int kBlockY = 4;

__global__ void __launch_bounds__(kBlockX * kBlockY)
stencil_matvec_kernel(const float2* __restrict__ cc,
                      const float2* __restrict__ cw,
                      const float2* __restrict__ ce,
                      const float2* __restrict__ cs,
                      const float2* __restrict__ cn,
                      const float2* __restrict__ u,
                      float2* __restrict__ y, int L, int n) {
    const int i = blockIdx.x * kBlockX + threadIdx.x;
    const int j = blockIdx.y * kBlockY + threadIdx.y;
    if (i >= n || j >= L) return;
    const long long k = (long long)j * n + i;
    float2 acc = make_float2(0.f, 0.f);
    acc = cfma(cc[k], u[k], acc);
    if (i > 0) acc = cfma(cw[k], u[k - 1], acc);
    if (i < n - 1) acc = cfma(ce[k], u[k + 1], acc);
    if (j > 0) acc = cfma(cs[k], u[k - n], acc);
    if (j < L - 1) acc = cfma(cn[k], u[k + n], acc);
    y[k] = acc;
}

}  // namespace

extern "C" int hh_stencil_matvec(const void* cc, const void* cw,
                                 const void* ce, const void* cs,
                                 const void* cn, const void* u, void* y,
                                 int L, int n, void* stream) {
    dim3 block(kBlockX, kBlockY);
    dim3 grid((n + kBlockX - 1) / kBlockX, (L + kBlockY - 1) / kBlockY);
    stencil_matvec_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
        (const float2*)cc, (const float2*)cw, (const float2*)ce,
        (const float2*)cs, (const float2*)cn, (const float2*)u, (float2*)y,
        L, n);
    return (int)cudaGetLastError();
}
