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
// Bound: operations, 8 k^3 float32 operations a matrix on the CUDA cores
// against 16 k^2 bytes (the matrix read once, the inverse written once).
// That bound is reached only with many matrices on every SM.  At a batch
// of one (the H_F inverses of a lerped setup, the exact factorization's
// layer inverses) the floor is one launch plus k DEPENDENT steps on one
// SM: each step needs the previous step's row j and column j.  So the
// design cuts the latency of a step, not its arithmetic.
//
// Design:
//   * k is a template parameter, K in {32, 64, 128}; a smaller k runs in
//     the next width with an identity tail, padded while the panel is
//     loaded into registers, never in device memory.  The inverse of
//     blockdiag(A, I) is blockdiag(A^{-1}, I), and the steps j >= k would
//     leave the tail as it is, so the loop stops at k and the result is
//     exact.
//   * One block per matrix.  Each thread owns a fixed TR x TC tile of the
//     panel in REGISTERS for all k steps (4 x 4 complex values with 256
//     threads at K = 64, 4 x 8 with 512 threads at K = 128, 4 x 4 with 64
//     threads at K = 32).  The panel never sits in shared memory.  With
//     k == K it is loaded and stored with 16-byte accesses, neighbouring
//     threads on neighbouring addresses: one read and one write of device
//     memory, as the TPU kernel keeps its panel in VMEM.
//   * One barrier a step.  At step j the threads that own column j and row
//     j publish them, as they are, into buffer j & 1 of a double-buffered
//     pair of shared vectors; one __syncthreads; then every thread takes
//     the pivot from the row, its reciprocal through `inv_pivot` (the one
//     place it is taken), scales the row elements of its own columns, and
//     updates its tile.  Row j and column j are handled by selects on the
//     unrolled compile-time tile indices: column j is zeroed and its row
//     factor set to 1/p, row j is zeroed and its column factor set to -1,
//     so one multiply-subtract form gives all four cases above.  A writer
//     of buffer (j + 1) & 1 has passed barrier j, so every reader of that
//     buffer at step j - 1 is done with it: one barrier is enough.
//   * Registers, not shared memory (4 KB), bound the blocks an SM holds,
//     so a large batch keeps several matrices on every SM.
// Not chosen: spreading one matrix over a thread-block cluster.  The step
// is bound by the latency of its barrier and its dependent loads, and a
// cluster would add a cross-SM barrier to every step.
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxK = 128;

// A thread's tile.  At K = 64, 4 x 4 (256 threads a matrix) was faster
// than 4 x 8 (128 threads) at batches 1, 146 and 1000 on an H100 (PERF.md).
template <int K>
struct Tile;
template <>
struct Tile<32> { static constexpr int TR = 4, TC = 4; };
template <>
struct Tile<64> { static constexpr int TR = 4, TC = 4; };
template <>
struct Tile<128> { static constexpr int TR = 4, TC = 8; };

template <int K>
constexpr int threads_of() {
    return (K / Tile<K>::TR) * (K / Tile<K>::TC);
}

__device__ __forceinline__ float2 cmul(float2 a, float2 b) {
    return make_float2(a.x * b.x - a.y * b.y, a.x * b.y + a.y * b.x);
}

__device__ __forceinline__ float2 inv_pivot(float2 p) {
    const float d = p.x * p.x + p.y * p.y;
    return make_float2(p.x / d, -p.y / d);
}

// a, out: the batch, k x k each, row-major.  vec: k == K and both pointers
// 16-byte aligned, so rows load and store as float4.
template <int K>
__global__ void __launch_bounds__(threads_of<K>())
gj_inverse_kernel(const float2* __restrict__ a, float2* __restrict__ out,
                  int k, int vec) {
    constexpr int TR = Tile<K>::TR;
    constexpr int TC = Tile<K>::TC;
    constexpr int GX = K / TC;          // threads along a row
    // [parity][0: column j, 1: row j][K]
    __shared__ __align__(16) float2 buf[2][2][K];

    const int tx = threadIdx.x % GX;
    const int ty = threadIdx.x / GX;
    const int r0 = ty * TR;
    const int c0 = tx * TC;
    const long long base = (long long)blockIdx.x * k * k;

    float2 x[TR][TC];
    if (vec) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
            const float4* src =
                reinterpret_cast<const float4*>(a + base + (r0 + i) * K + c0);
#pragma unroll
            for (int l = 0; l < TC / 2; ++l) {
                const float4 q = __ldg(src + l);
                x[i][2 * l] = make_float2(q.x, q.y);
                x[i][2 * l + 1] = make_float2(q.z, q.w);
            }
        }
    } else {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int l = 0; l < TC; ++l) {
                const int r = r0 + i, c = c0 + l;
                x[i][l] = (r < k && c < k)
                    ? a[base + (long long)r * k + c]
                    : make_float2(r == c ? 1.f : 0.f, 0.f);
            }
        }
    }

    // the owners of column j and of row j write them to buffer p
    auto publish = [&](int j, int p) {
        const int jc = j / TC, jl = j % TC;
        const int jr = j / TR, ji = j % TR;
        if (tx == jc) {
#pragma unroll
            for (int i = 0; i < TR; ++i) {
                float2 v = x[i][0];
#pragma unroll
                for (int l = 1; l < TC; ++l) v = (l == jl) ? x[i][l] : v;
                buf[p][0][r0 + i] = v;
            }
        }
        if (ty == jr) {
#pragma unroll
            for (int l = 0; l < TC; ++l) {
                float2 v = x[0][l];
#pragma unroll
                for (int i = 1; i < TR; ++i) v = (i == ji) ? x[i][l] : v;
                buf[p][1][c0 + l] = v;
            }
        }
    };

    publish(0, 0);
    for (int j = 0; j < k; ++j) {
        const int p = j & 1;
        __syncthreads();
        const float2 ip = inv_pivot(buf[p][1][j]);
        float2 cv[TR], rv[TC];
#pragma unroll
        for (int i = 0; i < TR; ++i) {
            const float2 v = buf[p][0][r0 + i];
            cv[i] = (r0 + i == j) ? make_float2(-1.f, 0.f) : v;
        }
#pragma unroll
        for (int l = 0; l < TC; ++l) {
            const float2 v = cmul(buf[p][1][c0 + l], ip);
            rv[l] = (c0 + l == j) ? ip : v;
        }
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int l = 0; l < TC; ++l) {
                float2 v = x[i][l];
                if (r0 + i == j || c0 + l == j) v = make_float2(0.f, 0.f);
                v.x = fmaf(-cv[i].x, rv[l].x, v.x);
                v.x = fmaf(cv[i].y, rv[l].y, v.x);
                v.y = fmaf(-cv[i].x, rv[l].y, v.y);
                v.y = fmaf(-cv[i].y, rv[l].x, v.y);
                x[i][l] = v;
            }
        }
        if (j + 1 < k) publish(j + 1, p ^ 1);
    }

    if (vec) {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
            float4* dst =
                reinterpret_cast<float4*>(out + base + (r0 + i) * K + c0);
#pragma unroll
            for (int l = 0; l < TC / 2; ++l)
                dst[l] = make_float4(x[i][2 * l].x, x[i][2 * l].y,
                                     x[i][2 * l + 1].x, x[i][2 * l + 1].y);
        }
    } else {
#pragma unroll
        for (int i = 0; i < TR; ++i) {
#pragma unroll
            for (int l = 0; l < TC; ++l) {
                const int r = r0 + i, c = c0 + l;
                if (r < k && c < k) out[base + (long long)r * k + c] = x[i][l];
            }
        }
    }
}

template <int K>
int launch(const float2* a, float2* out, int batch, int k,
           cudaStream_t stream) {
    const int vec = k == K && reinterpret_cast<uintptr_t>(a) % 16 == 0
                    && reinterpret_cast<uintptr_t>(out) % 16 == 0;
    gj_inverse_kernel<K><<<batch, threads_of<K>(), 0, stream>>>(a, out, k,
                                                                vec);
    return (int)cudaGetLastError();
}

}  // namespace

// a, out: (batch, k, k) complex64, contiguous; 1 <= k <= 128.  Returns a
// CUDA error code (0 on success).
extern "C" int hh_gj_inverse(const void* a, void* out, int batch, int k,
                             void* stream) {
    if (k < 1 || k > kMaxK || batch < 1) return (int)cudaErrorInvalidValue;
    const float2* src = (const float2*)a;
    float2* dst = (float2*)out;
    cudaStream_t s = (cudaStream_t)stream;
    if (k <= 32) return launch<32>(src, dst, batch, k, s);
    if (k <= 64) return launch<64>(src, dst, batch, k, s);
    return launch<128>(src, dst, batch, k, s);
}
