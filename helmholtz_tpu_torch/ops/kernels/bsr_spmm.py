"""Block-sparse times dense kernel wrapper: Y = A X for a complex BSR matrix
A and a dense X.

Replaces the TPU kernel `_kernel` / `pallas_bsr_matmat` of the JAX package's
`ops/pallas/bsr_spmm.py`.  The CUDA source is `csrc/bsr_spmm.cu`.

Bound: bytes at small K (every stored block is read once, X and Y once,
against 8 * nblocks * bm * bn * K operations), bytes and the float32 rate
together near K = 16; see the source note.  Empty block rows give zero
rows; any block size and any K >= 1 are taken.

The work is cut into units of (chunk of stored blocks, row tile, K tile)
that fill the card whatever the number of block rows; `launch_plan` sizes
them from the shape, nblocks, K and the SM count.  The sums that a chunk
cuts are added in one fixed order, so Y is the same bits from one call to
the next.

The plain version is `plain_bsr_matmat`, the JAX package's segment-sum
formulation (`ops/spmv.bsr_matmat`): one batched product over the stored
blocks and an `index_add_` into the block rows.  The wrapper takes it only
for tensors on the CPU; on CUDA tensors it launches the kernel or raises.
"""
from __future__ import annotations

import ctypes
import dataclasses
import functools

import torch

from ...core.sparse import BSR
from . import build

#: number of kernel launches made by `bsr_matmat` in this process (one a
#: call: the main kernel, with its fix-up pass where the plan cuts rows)
launches = 0

#: the largest K the streaming kernel takes (its K tiles are 1, 2, 4, 8)
STREAM_MAX_K = 8
#: rows a lane of the streaming kernel reads; threads of a streaming block
STREAM_ROWS_PER_LANE = 4
STREAM_THREADS = 256
#: columns of X a unit of the tiled kernel owns; most columns of A in one
#: stage (its row pitch in shared memory is `a_pitch`)
TILE_K = 16
TILE_COLS = 32
#: units the plan aims at on each SM: warps of the streaming kernel, blocks
#: of the tiled kernel
STREAM_WARPS_PER_SM = 96
TILE_BLOCKS_PER_SM = 32


def reset_counts() -> None:
    global launches
    launches = 0


def plain_bsr_matmat(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X (ncols, K): the stored blocks times the
    matching block rows of X, summed into the block rows of Y."""
    bm, bn = A.blocksize
    K = X.shape[1]
    Xb = X.reshape(-1, bn, K)
    contrib = torch.bmm(A.data, Xb[A.indices.long()])        # (nb, bm, K)
    out = torch.zeros((A.shape[0] // bm, bm, K),
                      dtype=torch.result_type(A.data, X), device=X.device)
    out.index_add_(0, A.block_rows(), contrib)
    return out.reshape(A.shape[0], K)


def check_kernel_args(A: BSR, X: torch.Tensor) -> None:
    """What the kernel takes: complex64 contiguous blocks (nblocks, bm, bn)
    and X (ncols, K), int32 indices and indptr, all on X's device.  Raises
    otherwise."""
    bm, bn = A.blocksize
    M, N = A.shape
    if X.ndim != 2 or X.shape[0] != N or X.shape[1] < 1:
        raise ValueError(f"the BSR kernel takes X of shape ({N}, K), got "
                         f"{tuple(X.shape)}")
    if M % bm or N % bn or A.data.shape[1:] != (bm, bn):
        raise ValueError(f"blocks {tuple(A.data.shape)} do not tile the "
                         f"shape {A.shape} by {A.blocksize}")
    if A.indptr.shape != (M // bm + 1,) \
            or A.indices.shape != (A.data.shape[0],):
        raise ValueError("indptr / indices do not match the block layout")
    device = X.device
    for name, t, dtype in (("data", A.data, torch.complex64),
                           ("X", X, torch.complex64),
                           ("indices", A.indices, torch.int32),
                           ("indptr", A.indptr, torch.int32)):
        if t.dtype != dtype:
            raise TypeError(f"the BSR kernel takes {name} as {dtype}, got "
                            f"{t.dtype}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, X on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one product of A (`nbrows` block rows of (bm, bn) blocks,
    `nblocks` stored) and X (K columns) is laid on the card.  The stored
    blocks, in CSR order, are cut into `chunks` chunks of `chunk` blocks; a
    unit is (chunk, row tile of `row_tile` rows, K tile of `k_tile`
    columns), and the units are ordered row tile fastest, then K tile, then
    chunk.

    `tiled` False: the streaming kernel, one warp a unit, `lanes` lanes a
    row (8, 16 or 32), `vec` complex values a load of A (2: 16 bytes);
    `threads` / 32 units a block.  `tiled` True: the register-tiled kernel,
    one block of `threads` = 4 * TR threads a unit, `lanes` = RM rows a
    thread (row_tile = TR * RM), two stages of `col_chunk` columns of A
    copied `vec` and of X copied `x_vec` complex values at a time;
    `shared_bytes` of dynamic shared memory.  `blocks` is the main kernel's
    grid; the fix-up kernel runs `chunks - 1` blocks when chunks > 1.
    `csrc/bsr_spmm.cu` checks the same relations."""
    nbrows: int
    bm: int
    bn: int
    K: int
    nblocks: int
    tiled: bool
    chunk: int
    chunks: int
    row_tile: int
    row_tiles: int
    k_tile: int
    k_tiles: int
    lanes: int
    vec: int
    x_vec: int
    col_chunk: int
    threads: int
    blocks: int
    shared_bytes: int

    @property
    def units(self) -> int:
        return self.chunks * self.k_tiles * self.row_tiles

    @functools.cached_property
    def words(self) -> ctypes.Array:
        """The plan as the C entry point takes it: its fields in order, as
        an int array made once."""
        fields = dataclasses.fields(self)
        return (ctypes.c_int * len(fields))(
            *(int(getattr(self, f.name)) for f in fields))


def a_pitch(tc: int) -> int:
    """Row pitch, in complex values, of a tiled stage of A holding tc
    columns, as `csrc/bsr_spmm.cu` sets it (even, and free of shared-memory
    bank conflicts)."""
    return tc + (4 if tc % 4 == 2 else 2)


def _stream_lanes(bn: int, vec: int) -> int:
    """Lanes a row: the one of 32, 16, 8 that leaves the fewest lanes idle
    on the ragged end of a row (the larger on a tie)."""
    pieces = -(-bn // vec)
    return min((32, 16, 8), key=lambda lpr: -(-pieces // lpr) * lpr - pieces)


def _tile_rows(bm: int) -> tuple[int, int]:
    """(TR, RM) of the tiled kernel: thread rows (a multiple of 8, at most
    32) and rows a thread (2 or 3), so that tiles of TR * RM rows waste the
    fewest rows of bm; then the most threads, then the fewer rows a thread
    (more blocks fit an SM: at bm = 511, 64-row tiles ran faster than
    128-row ones, RM = 4, on the H100; RM = 4 never wastes fewer rows than
    RM = 2, so the kernel has no such variant)."""
    best = None
    for rm in (3, 2):
        for tr in (8, 16, 24, 32):
            tm = tr * rm
            tiles = -(-bm // tm)
            key = (tiles * tm - bm, -tr, rm)
            if best is None or key < best[0]:
                best = (key, tr, rm)
    return best[1], best[2]


@functools.lru_cache(maxsize=None)
def launch_plan(nbrows: int, bm: int, bn: int, K: int, nblocks: int,
                sm_count: int, wide_a: bool = True,
                wide_x: bool = True) -> LaunchPlan:
    """The launch plan of Y = A X for A of nbrows block rows of (bm, bn)
    blocks, `nblocks` stored, and X of K columns, on a card of `sm_count`
    SMs.  `wide_a` / `wide_x`: the data / X pointers are 16-byte aligned,
    so that 16-byte loads may be used where bn / K are even.  Depends on
    nothing else, so it is cached: indptr is read by the kernels alone."""
    tiled = K > STREAM_MAX_K
    vec = 2 if wide_a and bn % 2 == 0 else 1
    if tiled:
        tr, rm = _tile_rows(bm)
        row_tile, k_tile, lanes = tr * rm, TILE_K, rm
        threads = 4 * tr
        x_vec = 2 if wide_x and K % 2 == 0 else 1
        pieces = -(-bn // TILE_COLS)
        col_chunk = -(-bn // pieces)
        col_chunk += col_chunk % 2 if vec == 2 else 0
        shared = 2 * (row_tile * a_pitch(col_chunk) + col_chunk * TILE_K) * 8
        target = TILE_BLOCKS_PER_SM * sm_count
    else:
        lanes = _stream_lanes(bn, vec)
        row_tile = STREAM_ROWS_PER_LANE * (32 // lanes)
        k_tile = next(kt for kt in (1, 2, 4, 8) if kt >= K)
        threads, x_vec, col_chunk, shared = STREAM_THREADS, 1, lanes * vec, 0
        target = STREAM_WARPS_PER_SM * sm_count
    row_tiles = -(-bm // row_tile)
    k_tiles = -(-K // k_tile)
    per_chunk = row_tiles * k_tiles
    chunk = max(1, nblocks * per_chunk // target)
    chunks = max(1, -(-nblocks // chunk))
    units = chunks * per_chunk
    blocks = units if tiled else -(-units // (threads // 32))
    return LaunchPlan(nbrows, bm, bn, K, nblocks, tiled, chunk, chunks,
                      row_tile, row_tiles, k_tile,
                      k_tiles, lanes, vec, x_vec, col_chunk, threads, blocks,
                      shared)


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def bsr_matmat(A: BSR, X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for dense X of shape (ncols, K); (nrows, K)."""
    global launches
    if X.device.type != "cuda":
        return plain_bsr_matmat(A, X)
    check_kernel_args(A, X)
    bm, bn = A.blocksize
    M, K = A.shape[0], X.shape[1]
    data = A.data
    plan = launch_plan(M // bm, bm, bn, K, data.shape[0], _sm_count(X.device),
                       data.data_ptr() % 16 == 0, X.data_ptr() % 16 == 0)
    Y = torch.empty((M, K), dtype=X.dtype, device=X.device)
    part = (torch.empty((plan.chunks, 2, bm, K), dtype=X.dtype,
                        device=X.device) if plan.chunks > 1 else None)
    args = (data.data_ptr(), A.indices.data_ptr(), A.indptr.data_ptr(),
            X.data_ptr(), Y.data_ptr(),
            part.data_ptr() if part is not None else None, plan.words)
    lib = build.library()
    # the raw query of the current stream: `torch.cuda.current_stream()`
    # builds a Stream object under a second device switch, a large share
    # of the host's cost of a call at small shapes (PERF.md, K4)
    with torch.cuda.device(X.device):
        status = lib.hh_bsr_spmm(
            *args, torch._C._cuda_getCurrentRawStream(X.device.index))
    build.check(status, "bsr_matmat")
    launches += 1
    return Y
