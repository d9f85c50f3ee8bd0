// Block-sparse (BSR) times dense, Y = A X, complex64, for sm_90a.
//
// Replaces the TPU kernel `_kernel` / `pallas_bsr_matmat` of
// helmholtz_tpu/ops/pallas/bsr_spmm.py.  There the grid walks the stored
// blocks in CSR order on one core, and the output tile stays resident while
// the block row is unchanged, so it accumulates for free.  Blocks of a CUDA
// grid run in no order, so the walk over a block row's stored blocks
// becomes a loop inside the block instead.
//
// Bound: bytes.  Every stored block is read once, X and Y once, against
// 8 * nblocks * bm * bn * K float32 operations: at K = 1 that is one
// operation a byte of A, far below what the card computes per byte.
//
// Design: one block per (block row, tile of up to 64 rows of bm, tile of
// TK columns of X).  For each stored block of its block row (read from
// indptr and indices on the device) it walks the block's columns in chunks
// of 32: the 64 x 32 piece of A and the matching 32 x TK rows of X are
// staged in shared memory with coalesced 8-byte complex loads, zero past
// the ragged edges of bm, bn and K, so any (bm, bn) and any K >= 1 work.
// Four threads share one output row, each summing every fourth column of
// the chunk in float32 registers with FMA; a two-step warp shuffle adds the
// four partial sums at the end, and the tile is written once.  No atomics:
// a block row with no stored blocks writes zeros.  No TF32 and no tensor
// cores, as the TPU kernel pins HIGHEST precision.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRows = 64;               // rows of the output tile
constexpr int kSplit = kThreads / kRows;  // threads that share one row
constexpr int kChunk = 32;              // columns of A staged at a time
constexpr int kALd = kChunk + 4;        // padded row pitch of the A piece

template <int TK>
__global__ void __launch_bounds__(kThreads)
bsr_spmm_kernel(const float2* __restrict__ data,
                const int* __restrict__ indices,
                const int* __restrict__ indptr,
                const float2* __restrict__ x, float2* __restrict__ y,
                int bm, int bn, int K) {
    constexpr int kXLd = TK + 1;        // padded row pitch of the X piece
    __shared__ float2 As[kRows * kALd];
    __shared__ float2 Xs[kChunk * kXLd];

    const int brow = blockIdx.x;
    const int r0 = blockIdx.y * kRows;
    const int k0 = blockIdx.z * TK;
    const int tid = threadIdx.x;
    const int m = tid / kSplit;         // output row of this thread
    const int s = tid % kSplit;         // columns s, s + 4, ... of a chunk

    float2 acc[TK];
#pragma unroll
    for (int k = 0; k < TK; ++k) acc[k] = make_float2(0.f, 0.f);

    const int p_end = indptr[brow + 1];
    for (int p = indptr[brow]; p < p_end; ++p) {
        const float2* blk = data + (long long)p * bm * bn;
        const long long xrow0 = (long long)indices[p] * bn;
        for (int c0 = 0; c0 < bn; c0 += kChunk) {
            for (int e = tid; e < kRows * kChunk; e += kThreads) {
                const int r = e / kChunk, c = e % kChunk;
                As[r * kALd + c] = (r0 + r < bm && c0 + c < bn)
                    ? blk[(long long)(r0 + r) * bn + c0 + c]
                    : make_float2(0.f, 0.f);
            }
            for (int e = tid; e < kChunk * TK; e += kThreads) {
                const int t = e / TK, k = e % TK;
                Xs[t * kXLd + k] = (c0 + t < bn && k0 + k < K)
                    ? x[(xrow0 + c0 + t) * K + k0 + k]
                    : make_float2(0.f, 0.f);
            }
            __syncthreads();
#pragma unroll
            for (int tt = 0; tt < kChunk / kSplit; ++tt) {
                const int t = tt * kSplit + s;
                const float2 a = As[m * kALd + t];
#pragma unroll
                for (int k = 0; k < TK; ++k) {
                    const float2 b = Xs[t * kXLd + k];
                    acc[k].x = fmaf(a.x, b.x, acc[k].x);
                    acc[k].x = fmaf(-a.y, b.y, acc[k].x);
                    acc[k].y = fmaf(a.x, b.y, acc[k].y);
                    acc[k].y = fmaf(a.y, b.x, acc[k].y);
                }
            }
            __syncthreads();
        }
    }

    // the kSplit threads of a row are neighbouring lanes of one warp
#pragma unroll
    for (int k = 0; k < TK; ++k) {
#pragma unroll
        for (int off = 1; off < kSplit; off *= 2) {
            acc[k].x += __shfl_xor_sync(0xffffffffu, acc[k].x, off);
            acc[k].y += __shfl_xor_sync(0xffffffffu, acc[k].y, off);
        }
    }
    if (r0 + m < bm) {
        float2* out = y + ((long long)brow * bm + r0 + m) * K + k0;
#pragma unroll
        for (int k = 0; k < TK; ++k) {
            if (k % kSplit == s && k0 + k < K) out[k] = acc[k];
        }
    }
}

template <int TK>
int launch(const void* data, const void* indices, const void* indptr,
           const void* x, void* y, int nbrows, int bm, int bn, int K,
           cudaStream_t stream) {
    dim3 grid(nbrows, (bm + kRows - 1) / kRows, (K + TK - 1) / TK);
    bsr_spmm_kernel<TK><<<grid, kThreads, 0, stream>>>(
        (const float2*)data, (const int*)indices, (const int*)indptr,
        (const float2*)x, (float2*)y, bm, bn, K);
    return (int)cudaGetLastError();
}

}  // namespace

// data: (nblocks, bm, bn) complex64; indices: (nblocks,) int32 block
// columns; indptr: (nbrows + 1,) int32; x: (ncols, K) complex64; y:
// (nbrows * bm, K) complex64, all contiguous.  Returns a CUDA error code.
extern "C" int hh_bsr_spmm(const void* data, const void* indices,
                           const void* indptr, const void* x, void* y,
                           int nbrows, int bm, int bn, int K, void* stream) {
    if (nbrows < 1 || bm < 1 || bn < 1 || K < 1)
        return (int)cudaErrorInvalidValue;
    cudaStream_t st = (cudaStream_t)stream;
    if (K > 8) return launch<16>(data, indices, indptr, x, y, nbrows, bm, bn,
                                 K, st);
    if (K > 1) return launch<4>(data, indices, indptr, x, y, nbrows, bm, bn,
                                K, st);
    return launch<1>(data, indices, indptr, x, y, nbrows, bm, bn, K, st);
}
