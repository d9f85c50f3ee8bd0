// Block-sparse (BSR) times dense, Y = A X, complex64, for sm_90a.
//
// Replaces the TPU kernel `_kernel` / `pallas_bsr_matmat` of
// helmholtz_tpu/ops/pallas/bsr_spmm.py.  There the grid walks the stored
// blocks in CSR order on one core, and the output tile stays resident while
// the block row is unchanged, so it accumulates for free.  Blocks of a CUDA
// grid run in parallel and in no order, so here the walk is cut into units
// and the sums that a cut splits are added in a second pass.
//
// Bound.  Every stored block is read once, X and Y once, against
// 8 * nblocks * bm * bn * K float32 operations.  At small K (one to a few
// columns) that is a few operations a byte of A: bytes bound it, and what
// counts is keeping enough loads in flight on every SM.  At K = 16 it is
// 16 operations a byte, near the card's balance of 20 (published float32
// rate over published memory rate; about 17 at the rates it reaches in
// plain reads and products): the FMA issue rate, the shared-memory loads
// per FMA and the warps an SM holds matter as much as the bytes.  Small
// matrices (tens of blocks) are bound by latency: the chain of dependent
// loads of a unit and the launches.  No TF32 and no tensor cores, as the
// TPU kernel pins HIGHEST precision and Hopper's tensor cores have no
// full-float32 mode.
//
// Work units (`ops/kernels/bsr_spmm.launch_plan` sets their sizes from
// the shape, nblocks, K and the SM count alone, not from indptr).  The
// stored blocks, in CSR order, are cut into chunks of `chunk` blocks; a
// unit is (chunk, row tile of the blocks, K tile).  A unit walks the block
// rows its chunk touches (`first_row`, a search in indptr); the result of
// a block row
// whose blocks all lie in the chunk goes straight to Y, that of a block
// row cut by the chunk's start to the chunk's "head" slot of a scratch
// buffer, and that of a block row cut by its end to the "tail" slot.  The
// fix-up kernel then sums each cut block row's slots in chunk order: the
// tail of its first chunk, then the heads of the later ones.  It is a
// programmatic dependent launch, so its start overlaps the main kernel's
// end.  Each sum has one fixed order, so Y is the same bits from run to
// run; no atomics.  Empty block rows are zeroed by the unit whose chunk
// holds their position in indptr (the last chunk for those at the end).
// Units sized from the SM count fill the card whatever the number of
// block rows.
//
// Two data paths, chosen by K:
//
//  * K <= 8, `bsr_stream_kernel`: A goes from device memory straight into
//    registers, each element used for all K columns at once.  A warp owns
//    4 * (32 / LPR) rows of its row tile; LPR lanes share one row and read
//    neighbouring 16-byte pieces of it (8-byte where bn is odd), 4 rows a
//    lane.  The (block, column step) pairs of a block row are walked in
//    groups of up to 4 steps with two register buffers, the next group's
//    loads issued before the FMAs of this one and across block boundaries,
//    so 16 to 32 loads a lane stay in flight.  LPR is 8, 16 or 32,
//    whichever wastes the fewest lanes on the ragged end of a row (bn = 48
//    or 80: 8).  X's piece comes through the L1 cache, the same on-chip
//    memory as shared memory, with no barrier.  A row's LPR partial sums
//    meet in a warp shuffle tree.  K pads to KT = 1, 2, 4 or 8, so K = 5
//    reads A once.
//
//  * K > 8, `bsr_tile_kernel`: a block of 4 * TR threads owns an output
//    tile of TM = RM * TR rows by 16 columns; each thread keeps RM x 4
//    complex sums in registers, so every shared-memory load feeds 4 * RM
//    or 16 FMAs.  RM (2 or 3) and TR (8 to 32) are set so that TM wastes
//    the fewest rows (bm = 48: 48, not 64) with the most threads.  The
//    pieces of A (TM rows by up to 32 columns, the width set from bn so
//    the last piece is not mostly empty) and of X are copied with cp.async
//    (16 bytes where the row pitch allows) into two stages: the copy of the
//    next piece runs while the FMAs use this one, with ONE barrier a stage
//    (three or four stages fit fewer blocks on an SM and were slower).  Rows past bm, columns past bn and K read
//    zeros.
#include <cuda_runtime.h>

#include <map>
#include <mutex>

namespace {

constexpr int kStreamWarps = 8;     // warps of a streaming block
constexpr int kRowsPerLane = 4;     // rows a lane of the streaming kernel reads
constexpr int kTileK = 16;          // columns of X a tiled unit owns
constexpr int kTileCols = 32;       // most columns of A in a tiled stage
constexpr int kFixupThreads = 256;

struct Args {
    const float2* data;     // (nblocks, bm, bn)
    const int* indices;     // (nblocks,)
    const int* indptr;      // (nbrows + 1,)
    const float2* x;        // (ncols, K)
    float2* y;              // (nbrows * bm, K)
    float2* part;           // (chunks, 2, bm, K): head and tail slots
    int nbrows, bm, bn, K, nblocks;
    int chunk, chunks;      // stored blocks a chunk holds; number of chunks
    int row_tile, row_tiles, k_tiles;
    int col_chunk;          // tiled: columns of A a stage holds
};

struct Chunk {
    int q0, q1;             // stored blocks [q0, q1)
    bool last;
};

__device__ __forceinline__ Chunk chunk_of(const Args& a, int g) {
    Chunk c;
    c.q0 = g * a.chunk;
    c.q1 = min(c.q0 + a.chunk, a.nblocks);
    c.last = g == a.chunks - 1;
    return c;
}

// The first block row a chunk starting at q0 visits: the first row with
// indptr[b] == q0 (empty ones first), else the row that holds q0 and began
// before it.
__device__ __forceinline__ int first_row(const int* indptr, int nbrows,
                                         int q0) {
    int lo = 0, hi = nbrows;          // indptr[nbrows] = nblocks >= q0
    while (lo < hi) {
        const int mid = (lo + hi) >> 1;
        if (__ldg(indptr + mid) >= q0) hi = mid; else lo = mid + 1;
    }
    return __ldg(indptr + lo) == q0 ? lo : lo - 1;
}

// Does the walk of chunk c still visit block row b?  Rows that start at q1
// belong to the next chunk, except after the last one.
__device__ __forceinline__ bool visits(const Args& a, const Chunk& c, int b) {
    return b < a.nbrows && (c.last || __ldg(a.indptr + b) < c.q1);
}

__device__ __forceinline__ bool empty_row(const Args& a, int b) {
    return __ldg(a.indptr + b) == __ldg(a.indptr + b + 1);
}

// Where the (bm, K) result of block row b from chunk g goes: Y, or the
// chunk's head slot (the row began before the chunk), or its tail slot
// (the row goes on past the chunk).
__device__ __forceinline__ float2* destination(const Args& a, int g,
                                               const Chunk& c, int b) {
    const long long rows = (long long)a.bm * a.K;
    if (__ldg(a.indptr + b) < c.q0) return a.part + (2LL * g) * rows;
    if (__ldg(a.indptr + b + 1) > c.q1)
        return a.part + (2LL * g + 1) * rows;
    return a.y + (long long)b * rows;
}

// Row pitch, in complex values, of a stage of A holding tc columns: two
// more, or four where tc + 2 is a multiple of 4, so that it is even (16-byte
// rows when tc is) and the eight rows a warp reads at once lie 2 * pitch
// words apart, not a multiple of 8 mod 32: distinct banks.
__host__ __device__ __forceinline__ int a_pitch(int tc) {
    return tc + (tc % 4 == 2 ? 4 : 2);
}

__device__ __forceinline__ void cmac(float2& acc, float2 u, float2 v) {
    acc.x = fmaf(u.x, v.x, acc.x);
    acc.x = fmaf(-u.y, v.y, acc.x);
    acc.y = fmaf(u.x, v.y, acc.y);
    acc.y = fmaf(u.y, v.x, acc.y);
}

// -- K <= 8: A straight into registers ----------------------------------------

template <int KT, int V, int LPR>
__global__ void __launch_bounds__(kStreamWarps * 32)
bsr_stream_kernel(const Args a) {
    constexpr int SUB = 32 / LPR;               // rows one load step covers
    constexpr int RW = kRowsPerLane;
    constexpr int U = KT >= 8 ? 1 : (KT >= 4 ? 2 : 4);   // steps in flight
    const int lane = threadIdx.x & 31;
    const int warp = blockIdx.x * kStreamWarps + (threadIdx.x >> 5);
    if (warp >= a.chunks * a.row_tiles) return;  // whole warps leave
    const int g = warp / a.row_tiles;
    const int m0 = (warp % a.row_tiles) * a.row_tile + lane / LPR;
    const int ll = lane % LPR;
    const Chunk c = chunk_of(a, g);
    const int K = a.K, bm = a.bm, bn = a.bn;
    const int steps = (bn + LPR * V - 1) / (LPR * V);

    float2 acc[RW][KT];

    // lane ll of a row writes the entries (i, k) with (i * KT + k) % LPR ==
    // ll, so a row's entries go out from several lanes at once
    auto store = [&](int b, bool zero) {
        float2* dst = zero ? a.y + (long long)b * bm * K
                           : destination(a, g, c, b);
#pragma unroll
        for (int i = 0; i < RW; ++i) {
            const int m = m0 + i * SUB;
#pragma unroll
            for (int k = 0; k < KT; ++k) {
                if ((i * KT + k) % LPR == ll && m < bm && k < K)
                    dst[(long long)m * K + k] =
                        zero ? make_float2(0.f, 0.f) : acc[i][k];
            }
        }
    };

    // A row's work is the sequence of (stored block, column step) pairs of
    // its blocks in this chunk, walked in groups of U steps with two
    // register buffers: the loads of the next group go out before the FMAs
    // of this one, across block boundaries too.  `col` is the block
    // column of the block after the cursor's, loaded one block ahead.
    float2 av[2][U][RW][V];
    float2 xv[2][U][V][KT];
    int q = 0, qe = 0, s = 0, col = 0;
    const float2* blk = a.data;
    const float2* xb = a.x;
    auto enter = [&](int qq) {               // the cursor moves to block qq
        q = qq;
        blk = a.data + (long long)q * bm * bn;
        xb = a.x + (long long)col * bn * K;
        if (q + 1 < qe) col = __ldg(a.indices + q + 1);
    };
    auto issue = [&](int buf) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
            const int cc = (s * LPR + ll) * V;
            const bool ok = q < qe && cc < bn;
#pragma unroll
            for (int i = 0; i < RW; ++i) {
                const int m = m0 + i * SUB;
                const float2* p = blk + (long long)m * bn + cc;
                if constexpr (V == 2) {
                    const float4 t = (ok && m < bm)
                        ? __ldcs(reinterpret_cast<const float4*>(p))
                        : make_float4(0.f, 0.f, 0.f, 0.f);
                    av[buf][u][i][0] = make_float2(t.x, t.y);
                    av[buf][u][i][1] = make_float2(t.z, t.w);
                } else {
                    av[buf][u][i][0] = (ok && m < bm)
                        ? __ldcs(p) : make_float2(0.f, 0.f);
                }
            }
#pragma unroll
            for (int v = 0; v < V; ++v)
#pragma unroll
                for (int k = 0; k < KT; ++k)
                    xv[buf][u][v][k] = (ok && k < K)
                        ? __ldg(xb + (long long)(cc + v) * K + k)
                        : make_float2(0.f, 0.f);
            if (q < qe && ++s == steps) {
                s = 0;
                if (q + 1 < qe) enter(q + 1); else q = qe;
            }
        }
    };
    auto compute = [&](int buf) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
            for (int i = 0; i < RW; ++i)
#pragma unroll
                for (int v = 0; v < V; ++v)
#pragma unroll
                    for (int k = 0; k < KT; ++k)
                        cmac(acc[i][k], av[buf][u][i][v], xv[buf][u][v][k]);
    };

    int b = first_row(a.indptr, a.nbrows, c.q0);
    for (;;) {
        while (visits(a, c, b) && empty_row(a, b)) store(b++, true);
        if (!visits(a, c, b)) break;
        const int qa = max(__ldg(a.indptr + b), c.q0);
        qe = min(__ldg(a.indptr + b + 1), c.q1);
        s = 0;
        col = __ldg(a.indices + qa);
        enter(qa);
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
            for (int k = 0; k < KT; ++k) acc[i][k] = make_float2(0.f, 0.f);
        const int total = (qe - qa) * steps;
        issue(0);
        for (int t = 0; t < total; t += 2 * U) {
            issue(1);
            compute(0);
            issue(0);
            compute(1);
        }
        // the LPR lanes of a row are neighbours in the warp
#pragma unroll
        for (int i = 0; i < RW; ++i)
#pragma unroll
            for (int k = 0; k < KT; ++k)
#pragma unroll
                for (int off = LPR / 2; off >= 1; off /= 2) {
                    acc[i][k].x += __shfl_xor_sync(0xffffffffu, acc[i][k].x,
                                                   off);
                    acc[i][k].y += __shfl_xor_sync(0xffffffffu, acc[i][k].y,
                                                   off);
                }
        store(b++, false);
    }
}

// -- K > 8: register tiles over staged pieces ---------------------------------

__device__ __forceinline__ void cp_async(void* dst, const void* src,
                                         bool valid, int bytes) {
    const unsigned s = (unsigned)__cvta_generic_to_shared(dst);
    const int n = valid ? bytes : 0;    // 0: fill the destination with zeros
    if (bytes == 16)
        asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
                     :: "r"(s), "l"(src), "r"(n));
    else
        asm volatile("cp.async.ca.shared.global [%0], [%1], 8, %2;\n"
                     :: "r"(s), "l"(src), "r"(n));
}

__device__ __forceinline__ void cp_async_commit() {
    asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
    asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// At most 128 threads; the register caps that the minimum of resident
// blocks sets (85 at RM = 2, 128 at RM = 3) keep the sums in registers
// with no spill, and at RM = 2 let five or six blocks share an SM (the
// compiler's own choice spilled and ran slower at the n = 511 operator).
template <int RM, bool AW, bool XW>
__global__ void __launch_bounds__(128, RM == 2 ? 6 : 4)
bsr_tile_kernel(const Args a) {
    extern __shared__ float4 smem4[];
    float2* smem = reinterpret_cast<float2*>(smem4);
    constexpr int AV = AW ? 2 : 1;              // complex values a copy of A
    constexpr int XV = XW ? 2 : 1;              // ... and of X
    constexpr int XP = kTileK / XV;             // copies a row of X's piece
    const int nthreads = blockDim.x;
    const int TR = nthreads / 4;                // thread rows
    const int TM = TR * RM;                     // == a.row_tile
    const int TC = a.col_chunk;
    // a stage holds TM rows of TC columns of A at row pitch ALD and TC rows
    // of 16 columns of X
    const int ALD = a_pitch(TC);
    float2* As = smem;                          // [2][TM][ALD]
    float2* Xs = smem + 2 * TM * ALD;           // [2][TC][kTileK]
    const int tid = threadIdx.x, tk = tid & 3, tr = tid >> 2;
    int u = blockIdx.x;
    const int row0 = (u % a.row_tiles) * TM;
    u /= a.row_tiles;
    const int k0 = (u % a.k_tiles) * kTileK;
    const int g = u / a.k_tiles;
    const Chunk c = chunk_of(a, g);
    const int K = a.K, bm = a.bm, bn = a.bn;
    const int ncc = (bn + TC - 1) / TC;         // pieces a block is cut into
    const int S = (c.q1 - c.q0) * ncc;          // stages of this unit

    // this thread's first copy of a stage and the step to its next, so the
    // copy loops divide nothing
    const int per_row = TC / AV;                // TC is even when AW
    const int a_pieces = TM * per_row;
    const int a_r = tid / per_row, a_c = tid % per_row * AV;
    const int a_dr = nthreads / per_row, a_dc = nthreads % per_row * AV;
    const int x_pieces = TC * XP;
    const int x_r = tid / XP, x_c = tid % XP * XV;
    const int x_dr = nthreads / XP;             // nthreads is a multiple of XP

    // the loader's place: stored block lq, first column lc
    int lq = c.q0, lc = 0;
    auto load = [&](int buf) {
        const float2* blk = a.data + (long long)lq * bm * bn
                            + (long long)row0 * bn + lc;
        const float2* xp = a.x + ((long long)__ldg(a.indices + lq) * bn + lc)
                           * K + k0;
        float2* ad = As + buf * TM * ALD;
        float2* xd = Xs + buf * TC * kTileK;
        int r = a_r, cc = a_c;
        for (int e = tid; e < a_pieces; e += nthreads) {
            const bool ok = row0 + r < bm && lc + cc < bn;
            cp_async(ad + r * ALD + cc,
                     ok ? blk + (long long)r * bn + cc : a.data, ok, 8 * AV);
            r += a_dr;
            cc += a_dc;
            if (cc >= TC) { cc -= TC; ++r; }
        }
        r = x_r;
        for (int e = tid; e < x_pieces; e += nthreads, r += x_dr) {
            const bool ok = lc + r < bn && k0 + x_c < K;
            cp_async(xd + r * kTileK + x_c,
                     ok ? xp + (long long)r * K + x_c : a.x, ok, 8 * XV);
        }
        cp_async_commit();
        lc += TC;
        if (lc >= bn) { lc = 0; ++lq; }
    };

    // the first stage's copies go out before the walk's search
    if (S > 0) load(0);

    float2 acc[RM][4];
    auto store = [&](int b, bool zero) {
        float2* dst = zero ? a.y + (long long)b * bm * K
                           : destination(a, g, c, b);
#pragma unroll
        for (int i = 0; i < RM; ++i) {
            const int m = row0 + tr + i * TR;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const int k = k0 + tk * 4 + j;
                if (m < bm && k < K)
                    dst[(long long)m * K + k] =
                        zero ? make_float2(0.f, 0.f) : acc[i][j];
            }
        }
    };
    auto reset = [&]() {
#pragma unroll
        for (int i = 0; i < RM; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) acc[i][j] = make_float2(0.f, 0.f);
    };

    int b = first_row(a.indptr, a.nbrows, c.q0);
    while (visits(a, c, b) && empty_row(a, b)) store(b++, true);
    reset();
    int q = c.q0, c0 = 0;                       // the compute's place
    for (int s = 0; s < S; ++s) {
        cp_async_wait_all();
        // every thread's copies of stage s have landed, and every thread is
        // done with stage s - 1, whose buffer the next copy refills
        __syncthreads();
        if (s + 1 < S) load((s + 1) & 1);
        const float2* ap = As + (s & 1) * TM * ALD + tr * ALD;
        const float2* xp = Xs + (s & 1) * TC * kTileK + tk * 4;
        const int tc = min(TC, bn - c0);
#pragma unroll 4
        for (int cc = 0; cc < tc; ++cc) {
            float2 av[RM];
#pragma unroll
            for (int i = 0; i < RM; ++i) av[i] = ap[i * TR * ALD + cc];
            const float4 x01 = *reinterpret_cast<const float4*>(
                xp + cc * kTileK);
            const float4 x23 = *reinterpret_cast<const float4*>(
                xp + cc * kTileK + 2);
            const float2 xv[4] = {make_float2(x01.x, x01.y),
                                  make_float2(x01.z, x01.w),
                                  make_float2(x23.x, x23.y),
                                  make_float2(x23.z, x23.w)};
#pragma unroll
            for (int i = 0; i < RM; ++i)
#pragma unroll
                for (int j = 0; j < 4; ++j) cmac(acc[i][j], av[i], xv[j]);
        }
        c0 += TC;
        if (c0 >= bn) {
            // the last piece of block q: if it is the block row's last in
            // this chunk, the row's sum is done
            c0 = 0;
            if (++q == min(__ldg(a.indptr + b + 1), c.q1)) {
                store(b++, false);
                reset();
                while (visits(a, c, b) && empty_row(a, b)) store(b++, true);
            }
        }
    }
}

// -- the sums of the block rows that chunks cut -------------------------------

// Block g handles the cut at stored block qb = (g + 1) * chunk: if the
// block row holding qb began in the chunk just before (and not at qb), it
// is summed here, its first chunk's tail then the later chunks' heads.  It
// is launched as a programmatic dependent launch: its search runs while
// the main kernel ends, and `griddepcontrol.wait` holds it until the main
// kernel's writes are done and visible.
__global__ void __launch_bounds__(kFixupThreads)
bsr_fixup_kernel(const Args a) {
    const int g = blockIdx.x + 1;
    const int qb = g * a.chunk;
    int lo = 0, hi = a.nbrows - 1;      // the last row with indptr <= qb
    while (lo < hi) {
        const int mid = (lo + hi + 1) >> 1;
        if (__ldg(a.indptr + mid) <= qb) lo = mid; else hi = mid - 1;
    }
    const int b = lo;
    const int start = __ldg(a.indptr + b);
    if (start == qb || start < qb - a.chunk) return;
    const int g1 = (__ldg(a.indptr + b + 1) - 1) / a.chunk;
    const long long rows = (long long)a.bm * a.K;
    asm volatile("griddepcontrol.wait;\n" ::: "memory");
    for (long long e = threadIdx.x; e < rows; e += kFixupThreads) {
        float2 s = a.part[(2LL * (g - 1) + 1) * rows + e];
        for (int h = g; h <= g1; ++h) {
            const float2 p = a.part[2LL * h * rows + e];
            s.x += p.x;
            s.y += p.y;
        }
        a.y[(long long)b * rows + e] = s;
    }
}

// -- launch -------------------------------------------------------------------

std::mutex smem_mutex;

// Allows `kernel` `smem` bytes of dynamic shared memory on the current
// device, asking the runtime once per kernel instance and device.
template <typename Kernel>
cudaError_t allow_smem(Kernel kernel, std::map<int, int>& allowed,
                       int smem) {
    if (smem <= 48 * 1024) return cudaSuccess;
    int device = 0;
    cudaError_t e = cudaGetDevice(&device);
    if (e != cudaSuccess) return e;
    std::lock_guard<std::mutex> lock(smem_mutex);
    int& have = allowed[device];
    if (smem > have) {
        e = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
        if (e != cudaSuccess) return e;
        have = smem;
    }
    return cudaSuccess;
}

template <int KT, int V, int LPR>
cudaError_t run_stream(const Args& a, int blocks, cudaStream_t st) {
    bsr_stream_kernel<KT, V, LPR><<<blocks, kStreamWarps * 32, 0, st>>>(a);
    return cudaGetLastError();
}

template <int KT, int V>
cudaError_t stream_lanes(const Args& a, int lanes, int blocks,
                         cudaStream_t st) {
    switch (lanes) {
        case 8: return run_stream<KT, V, 8>(a, blocks, st);
        case 16: return run_stream<KT, V, 16>(a, blocks, st);
        case 32: return run_stream<KT, V, 32>(a, blocks, st);
    }
    return cudaErrorInvalidValue;
}

template <int KT>
cudaError_t stream_vec(const Args& a, int vec, int lanes, int blocks,
                       cudaStream_t st) {
    return vec == 2 ? stream_lanes<KT, 2>(a, lanes, blocks, st)
                    : stream_lanes<KT, 1>(a, lanes, blocks, st);
}

template <int RM, bool AW, bool XW>
cudaError_t run_tile(const Args& a, int threads, int blocks, int smem,
                     cudaStream_t st) {
    static std::map<int, int> allowed;
    auto kernel = bsr_tile_kernel<RM, AW, XW>;
    cudaError_t e = allow_smem(kernel, allowed, smem);
    if (e != cudaSuccess) return e;
    kernel<<<blocks, threads, smem, st>>>(a);
    return cudaGetLastError();
}

template <int RM>
cudaError_t tile_vec(const Args& a, int vec, int x_vec, int threads,
                     int blocks, int smem, cudaStream_t st) {
    if (vec == 2)
        return x_vec == 2 ? run_tile<RM, true, true>(a, threads, blocks, smem, st)
                          : run_tile<RM, true, false>(a, threads, blocks, smem, st);
    return x_vec == 2 ? run_tile<RM, false, true>(a, threads, blocks, smem, st)
                      : run_tile<RM, false, false>(a, threads, blocks, smem, st);
}

}  // namespace

// data: (nblocks, bm, bn) complex64; indices: (nblocks,) int32 block
// columns; indptr: (nbrows + 1,) int32; x: (ncols, K) complex64; y:
// (nbrows * bm, K) complex64, all contiguous; part: scratch of (chunks, 2,
// bm, K) complex64 when chunks > 1.  plan: the 19 ints of
// `ops/kernels/bsr_spmm.LaunchPlan.words`, in this order: nbrows, bm, bn,
// K, nblocks, tiled, chunk, chunks, row_tile, row_tiles, k_tile, k_tiles,
// lanes, vec, x_vec, col_chunk, threads, blocks, shared_bytes.
// Launches the main kernel and, when chunks > 1, the fix-up kernel on
// `stream`.  Returns a CUDA error code: the runtime's refusal of a launch,
// or cudaErrorInvalidValue for a plan the kernels do not take.
extern "C" int hh_bsr_spmm(const void* data, const void* indices,
                           const void* indptr, const void* x, void* y,
                           void* part, const int* plan, void* stream) {
    const int nbrows = plan[0], bm = plan[1], bn = plan[2], K = plan[3],
              nblocks = plan[4], tiled = plan[5], chunk = plan[6],
              chunks = plan[7], row_tile = plan[8], row_tiles = plan[9],
              k_tile = plan[10], k_tiles = plan[11], lanes = plan[12],
              vec = plan[13], x_vec = plan[14], col_chunk = plan[15],
              threads = plan[16], blocks = plan[17], shared_bytes = plan[18];
    if (nbrows < 1 || bm < 1 || bn < 1 || K < 1 || nblocks < 0 || chunk < 1
            || chunks < 1 || blocks < 1 || (chunks > 1 && part == nullptr)
            || (vec == 2 && bn % 2) || (x_vec == 2 && K % 2))
        return (int)cudaErrorInvalidValue;
    Args a{(const float2*)data, (const int*)indices, (const int*)indptr,
           (const float2*)x, (float2*)y, (float2*)part,
           nbrows, bm, bn, K, nblocks, chunk, chunks,
           row_tile, row_tiles, k_tiles, col_chunk};
    cudaStream_t st = (cudaStream_t)stream;
    cudaError_t e = cudaErrorInvalidValue;
    if (tiled) {
        if (k_tile != kTileK || threads % 32 || threads > 128
                || row_tile != threads / 4 * lanes || col_chunk < 1
                || col_chunk > kTileCols || (vec == 2 && col_chunk % 2)
                || shared_bytes != 2 * (row_tile * a_pitch(col_chunk)
                                             + col_chunk * kTileK) * 8)
            return (int)cudaErrorInvalidValue;
        switch (lanes) {
            case 2: e = tile_vec<2>(a, vec, x_vec, threads, blocks,
                                    shared_bytes, st); break;
            case 3: e = tile_vec<3>(a, vec, x_vec, threads, blocks,
                                    shared_bytes, st); break;
        }
    } else {
        if (K > k_tile || k_tiles != 1 || threads != kStreamWarps * 32
                || row_tile != kRowsPerLane * (32 / lanes))
            return (int)cudaErrorInvalidValue;
        switch (k_tile) {
            case 1: e = stream_vec<1>(a, vec, lanes, blocks, st); break;
            case 2: e = stream_vec<2>(a, vec, lanes, blocks, st); break;
            case 4: e = stream_vec<4>(a, vec, lanes, blocks, st); break;
            case 8: e = stream_vec<8>(a, vec, lanes, blocks, st); break;
        }
    }
    if (e != cudaSuccess || chunks == 1) return (int)e;
    cudaLaunchAttribute attr;
    attr.id = cudaLaunchAttributeProgrammaticStreamSerialization;
    attr.val.programmaticStreamSerializationAllowed = 1;
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(chunks - 1);
    cfg.blockDim = dim3(kFixupThreads);
    cfg.stream = st;
    cfg.attrs = &attr;
    cfg.numAttrs = 1;
    e = cudaLaunchKernelEx(&cfg, bsr_fixup_kernel, a);
    if (e != cudaSuccess) return (int)e;
    return (int)cudaGetLastError();
}
