"""The launch plan of the block-sparse kernel K4 (`ops.kernels.bsr_spmm`):
how its units cut the work, checked on the CPU where the plan is plain
Python.  `chunk_walk` and `fixup_row` below state what each unit and each
fix-up block of `csrc/bsr_spmm.cu` does for a given indptr; here they are
held to cover every output entry once, to hand every stored block to one
unit of each row tile and K tile, and to sum the cut block rows in one
fixed order, and a product assembled by them is held against the plain
version.  The kernels themselves are held against the plain version on
the card by `chip_smoke.py`, at every instance `K4_INSTANCES` names.
"""
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch.ops.kernels import bsr_spmm as k4
from helmholtz_tpu_torch.scripts.common import (
    K4_INSTANCE_EMPTY, K4_INSTANCES, k4_instance)

SMS = 132   # the H100's SM count, which the plan sizes its units from


def chunk_walk(plan, indptr, g):
    """What every unit of chunk g does, as the kernels do it: for each block
    row b it visits, in order, (b, q_lo, q_hi, where) with its stored
    blocks [q_lo, q_hi) in the chunk and `where` one of "y" (its sum is Y's
    block row; zeros where the row has no stored block), "head" (the row
    began before the chunk) or "tail" (it goes on past the chunk)."""
    nbrows, nblocks = len(indptr) - 1, indptr[-1]
    q0, q1 = g * plan.chunk, min((g + 1) * plan.chunk, nblocks)
    last = g == plan.chunks - 1
    lo = next(b for b in range(nbrows + 1) if indptr[b] >= q0)
    b = lo if indptr[lo] == q0 else lo - 1
    out = []
    while b < nbrows and (last or indptr[b] < q1):
        start, end = indptr[b], indptr[b + 1]
        where = "head" if start < q0 else "tail" if end > q1 else "y"
        out.append((b, max(start, q0), min(end, q1), where))
        b += 1
    return out


def fixup_row(plan, indptr, g):
    """What fix-up block g (0 <= g < chunks - 1) does: None, or (b, slots)
    when it writes Y's block row b as the sum, in this order, of the
    partial slots `slots`, each (chunk, "head" or "tail")."""
    qb = (g + 1) * plan.chunk
    b = max(r for r in range(len(indptr) - 1) if indptr[r] <= qb)
    start = indptr[b]
    if start == qb or start < qb - plan.chunk:
        return None
    g1 = (indptr[b + 1] - 1) // plan.chunk
    return b, [(g, "tail")] + [(h, "head") for h in range(g + 1, g1 + 1)]


def stencil_indptr(n):
    """indptr of the n-point 5-point operator as BSR (`stencil_to_bsr`):
    n block rows of 2, 3, ..., 3, 2 blocks, 3n - 2 in all."""
    counts = [2] + [3] * (n - 2) + [2]
    return np.concatenate([[0], np.cumsum(counts)]).tolist()


def random_indptr(nbrows, nbcols, seed, empty=(3,)):
    rng = np.random.default_rng(seed)
    keep = rng.random((nbrows, nbcols)) < 0.4
    keep[0, 0] = True
    keep[list(empty), :] = False
    return np.concatenate([[0], np.cumsum(keep.sum(axis=1))]).tolist()


# (nbrows, bm, bn, K, indptr): one block row; the n = 511 operator at the
# three widths chip_smoke times; the random matrices of chip_smoke (block
# row 3 empty) at its block sizes; empty block rows first and last; one
# block row holding every stored block; no stored block at all; K past
# one tile of the tiled kernel
CASES = [
    (1, 64, 64, 1, [0, 1]),
    (1, 48, 80, 5, [0, 12]),
    (511, 511, 511, 1, stencil_indptr(511)),
    (511, 511, 511, 4, stencil_indptr(511)),
    (511, 511, 511, 16, stencil_indptr(511)),
    (16, 64, 64, 16, random_indptr(16, 12, 1)),
    (16, 128, 128, 5, random_indptr(16, 12, 2)),
    (16, 48, 80, 1, random_indptr(16, 12, 3)),
    (16, 48, 80, 16, random_indptr(16, 12, 4, empty=(0, 3, 15))),
    (16, 64, 64, 4, [0] * 6 + [40] * 11),
    (4, 33, 17, 3, [0, 0, 0, 0, 0]),
    (6, 24, 24, 40, random_indptr(6, 5, 5)),
]


def _ids(case):
    nbrows, bm, bn, K, indptr = case
    return f"{nbrows}x{bm}x{bn}-K{K}-nb{indptr[-1]}"


def _check_plan_covers_the_work_once(nbrows, bm, bn, K, indptr):
    nb = indptr[-1]
    plan = k4.launch_plan(nbrows, bm, bn, K, nb, SMS)
    assert plan.chunks == max(1, -(-nb // plan.chunk))
    assert (plan.row_tiles - 1) * plan.row_tile < bm \
        <= plan.row_tiles * plan.row_tile
    assert (plan.k_tiles - 1) * plan.k_tile < K <= plan.k_tiles * plan.k_tile
    if plan.tiled:
        assert K > k4.STREAM_MAX_K and plan.k_tile == k4.TILE_K
        assert plan.threads % 32 == 0 and plan.threads <= 128
        assert plan.row_tile == plan.threads // 4 * plan.lanes
        assert plan.blocks == plan.units
        assert plan.col_chunk <= k4.TILE_COLS
        assert plan.shared_bytes <= 232448
    else:
        assert plan.k_tile >= K and plan.k_tiles == 1
        assert plan.lanes * plan.vec * (-(-bn // (plan.lanes * plan.vec))) \
            >= bn
        assert plan.blocks * plan.threads // 32 >= plan.units

    owner = np.zeros(nb, dtype=int)
    writes = np.zeros(nbrows, dtype=int)
    slots = {}
    for g in range(plan.chunks):
        rows = [b for b, *_ in chunk_walk(plan, indptr, g)]
        assert rows == sorted(set(rows))
        for b, lo, hi, where in chunk_walk(plan, indptr, g):
            owner[lo:hi] += 1
            assert indptr[b] <= lo <= hi <= indptr[b + 1]
            if where == "y":
                writes[b] += 1
                assert (lo, hi) == (indptr[b], indptr[b + 1])
            else:
                assert (g, where) not in slots
                slots[(g, where)] = b
    np.testing.assert_array_equal(owner, 1)
    read = set()
    for g in range(plan.chunks - 1):
        fix = fixup_row(plan, indptr, g)
        if fix is None:
            continue
        b, order = fix
        writes[b] += 1
        assert order == sorted(order) and order[0] == (g, "tail")
        assert all(where == "head" for _, where in order[1:])
        for slot in order:
            assert slots[slot] == b and slot not in read
            read.add(slot)
    np.testing.assert_array_equal(writes, 1)
    assert read == set(slots)
    return plan


@pytest.mark.parametrize("case", CASES, ids=[_ids(c) for c in CASES])
def test_bsr_plan_covers_the_work_once(case):
    """Every stored block goes to exactly one chunk (so to one unit of each
    row tile and K tile); the row and K tiles cover bm and K once and fit
    the kernel's limits; every block row reaches Y exactly once, straight
    from one chunk or from one fix-up block; every partial slot written is
    read by exactly one fix-up, by the row that wrote it, in chunk order
    (the first chunk's tail, then the heads)."""
    _check_plan_covers_the_work_once(*case)


@pytest.mark.parametrize("instance, shape", K4_INSTANCES,
                         ids=["-".join(map(str, i)) for i, _ in K4_INSTANCES])
def test_bsr_plan_reaches_every_kernel_instance(instance, shape):
    """For each kernel instance the C entry point can launch, the shape
    `K4_INSTANCES` gives it (the one `chip_smoke.py` runs it at on the
    card) selects it, on a matrix with empty block rows and rows cut by
    chunks, and that plan passes the checks above: no instance is left
    that no plan reaches or that a plan reaches with a bad layout."""
    bm, bn, K = shape
    plan = _check_plan_covers_the_work_once(
        16, bm, bn, K, random_indptr(16, 12, 7, empty=K4_INSTANCE_EMPTY))
    assert k4_instance(plan) == instance


def test_bsr_instances_are_all_there():
    """K4_INSTANCES names each instance once: every (K tile, load width,
    lanes) of the streaming kernel and (rows, A width, X width) of the
    tiled one."""
    names = [i for i, _ in K4_INSTANCES]
    assert len(set(names)) == len(names) == 4 * 2 * 3 + 2 * 2 * 2


def _plan_product(A, X, plan):
    """Y assembled the way the kernels assemble it: each chunk's row sums
    over its blocks in order, into Y or a slot, then the fix-up sums."""
    bm, bn = A.blocksize
    indptr = A.indptr.tolist()
    Y = torch.full((A.shape[0] // bm, bm, X.shape[1]), float("nan"),
                   dtype=X.dtype)
    part = {}
    for g in range(plan.chunks):
        for b, lo, hi, where in chunk_walk(plan, indptr, g):
            acc = torch.zeros((bm, X.shape[1]), dtype=X.dtype)
            for q in range(lo, hi):
                c = int(A.indices[q])
                acc += A.data[q] @ X[c * bn:(c + 1) * bn]
            if where == "y":
                Y[b] = acc
            else:
                part[(g, where)] = acc
    for g in range(plan.chunks - 1):
        fix = fixup_row(plan, indptr, g)
        if fix is not None:
            b, order = fix
            Y[b] = part[order[0]]
            for slot in order[1:]:
                Y[b] += part[slot]
    return Y.reshape(A.shape[0], X.shape[1])


@pytest.mark.parametrize("bm, bn, K, empty", [(8, 8, 1, (3,)),
                                              (6, 10, 5, (0, 3, 7)),
                                              (8, 4, 17, (3, 7)),
                                              (7, 13, 2, (1,)),
                                              (12, 6, 33, (0, 7))])
def test_bsr_plan_product_matches_the_plain_version(bm, bn, K, empty):
    """At sizes the CPU takes in a moment, with the SM count set so the
    plan cuts rows (chunks of one and of three blocks), the product put
    together by the plan's walk and fix-ups equals the plain version to
    1e-13 in complex128, empty block rows zero."""
    rng = np.random.default_rng(21)
    nbr, nbc = 8, 6
    keep = rng.random((nbr, nbc)) < 0.6
    keep[list(empty), :] = False
    dense = ((rng.standard_normal((nbr * bm, nbc * bn))
              + 1j * rng.standard_normal((nbr * bm, nbc * bn)))
             .reshape(nbr, bm, nbc, bn) * keep[:, None, :, None]) \
        .reshape(nbr * bm, nbc * bn)
    A = ht.BSR.fromdense(dense, (bm, bn), device="cpu")
    X = torch.from_numpy(rng.standard_normal((nbc * bn, K))
                         + 1j * rng.standard_normal((nbc * bn, K)))
    ref = k4.plain_bsr_matmat(A, X)
    for sms in (1000, 1):
        plan = k4.launch_plan(nbr, bm, bn, K, A.data.shape[0], sms)
        got = _plan_product(A, X, plan)
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-13,
                                   atol=1e-13 * ref.abs().max().item())
    for b in empty:
        assert not got[b * bm:(b + 1) * bm].any()


def test_bsr_plan_is_cached_and_follows_the_pointers():
    """One plan per (shape, nblocks, K, SM count, alignment): the second
    call returns the same object; 8-byte loads where bn or K is odd or a
    pointer is not 16-byte aligned."""
    p = k4.launch_plan(16, 64, 64, 16, 77, SMS)
    assert k4.launch_plan(16, 64, 64, 16, 77, SMS) is p
    assert (p.vec, p.x_vec) == (2, 2)
    assert k4.launch_plan(16, 64, 64, 16, 77, SMS, False, False).vec == 1
    assert k4.launch_plan(511, 511, 511, 16, 1531, SMS).vec == 1
    assert k4.launch_plan(16, 64, 64, 17, 77, SMS).x_vec == 1
    # the ragged block sizes: no 64-row tile for bm = 48, lanes sized to bn
    assert k4.launch_plan(16, 48, 80, 16, 77, SMS).row_tile == 48
    assert k4.launch_plan(16, 48, 80, 1, 77, SMS).lanes == 8
