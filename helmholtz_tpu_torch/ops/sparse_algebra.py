"""Sparse matrix algebra: stencil add / scale / axpy / diagonal update, CSR
scale and add, the stencil as block-tridiagonal BSR, and the block-sparse
product (SpGEMM).

As in the JAX package, every sparsity pattern is computed on the host in
numpy from concrete index arrays (the symbolic phase); the numeric phase
runs on the values' device.  For the SpGEMM that is one batched product over
all contributing block pairs and one `index_add_` into the output blocks:
plain tensor code, as the JAX package leaves its einsum and segment sum to
its compiler.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core.sparse import BSR, CSR, Stencil5, _host, _index


# -- stencil algebra (same pattern by construction) ---------------------------

def stencil_add(A: Stencil5, B: Stencil5) -> Stencil5:
    return Stencil5(*(a + b for a, b in zip(A.fields(), B.fields())))


def stencil_scale(A: Stencil5, alpha) -> Stencil5:
    return A.map(lambda f: alpha * f)


def stencil_axpy(alpha, A: Stencil5, B: Stencil5) -> Stencil5:
    """alpha * A + B, for example a complex shift of the operator."""
    return Stencil5(*(alpha * a + b for a, b in zip(A.fields(), B.fields())))


def stencil_diag_update(A: Stencil5, d: torch.Tensor) -> Stencil5:
    """A + diag(d) for grid-shaped d: the H_m = K + diag(w_m) structure of
    the subgrid family, which differs only in its diagonal."""
    return Stencil5(cc=A.cc + d, cw=A.cw, ce=A.ce, cs=A.cs, cn=A.cn)


# -- CSR algebra --------------------------------------------------------------

def csr_scale(A: CSR, alpha) -> CSR:
    return CSR(alpha * A.data, A.indices, A.indptr, A.shape)


def csr_add_same_pattern(A: CSR, B: CSR) -> CSR:
    """A + B when both share indptr and indices."""
    return CSR(A.data + B.data, A.indices, A.indptr, A.shape)


def csr_add(A: CSR, B: CSR) -> CSR:
    """General A + B: the union pattern on the host, the values scattered
    on the device."""
    if A.shape != B.shape:
        raise ValueError(f"shapes differ: {A.shape} and {B.shape}")
    indptr, indices, a_map, b_map = _csr_union_pattern(A, B)
    dev = A.device
    data = torch.zeros(indices.shape[0],
                       dtype=torch.result_type(A.data, B.data), device=dev)
    data.index_add_(0, torch.as_tensor(a_map, device=dev), A.data)
    data.index_add_(0, torch.as_tensor(b_map, device=dev), B.data)
    return CSR(data, _index(indices, dev), _index(indptr, dev), A.shape)


def _csr_union_pattern(A: CSR, B: CSR):
    """Host symbolic phase: the union pattern and the place of every entry
    of A and of B in it."""
    nrows, ncols = A.shape
    a_ip, a_ix = _host(A.indptr), _host(A.indices)
    b_ip, b_ix = _host(B.indptr), _host(B.indices)
    a_rows = np.repeat(np.arange(nrows), np.diff(a_ip))
    b_rows = np.repeat(np.arange(nrows), np.diff(b_ip))
    keys = np.concatenate([a_rows.astype(np.int64) * ncols + a_ix,
                           b_rows.astype(np.int64) * ncols + b_ix])
    uniq, inv = np.unique(keys, return_inverse=True)
    a_map = inv[:a_ix.shape[0]]
    b_map = inv[a_ix.shape[0]:]
    rows = uniq // ncols
    cols = (uniq % ncols).astype(np.int32)
    indptr = np.zeros(nrows + 1, np.int64)
    np.add.at(indptr, rows + 1, 1)
    return np.cumsum(indptr), cols, a_map, b_map


# -- the stencil as BSR -------------------------------------------------------

def stencil_to_bsr(A: Stencil5) -> BSR:
    """A Stencil5 as block-tridiagonal BSR with (n, n) layer blocks: the
    tridiagonal diagonal blocks and the diagonal couplings, 3L - 2 blocks
    stored in CSR order, on the fields' device."""
    L, n = A.grid_shape
    dev = A.device
    # block row j holds sub_j (block column j-1), diag_j (j), sup_j (j+1)
    counts = np.full(L, 3)
    counts[[0, -1]] = 2 if L > 1 else 1
    indptr = np.concatenate([[0], np.cumsum(counts)])
    diag_slot = indptr[:-1] + (np.arange(L) > 0)
    cols = np.full(indptr[-1], -1)
    cols[diag_slot] = np.arange(L)
    cols[indptr[1:L]] = np.arange(L - 1)            # sub_j, j >= 1
    cols[diag_slot[:-1] + 1] = np.arange(1, L)      # sup_j, j < L-1
    # filled in place: the (3L - 2, n, n) stack is the only large buffer
    data = torch.zeros((indptr[-1], n, n), dtype=A.dtype, device=dev)
    slot = lambda a: torch.as_tensor(a, device=dev)[:, None]
    i = torch.arange(n, device=dev)
    d = slot(diag_slot)
    data[d, i, i] = A.cc
    data[d, i[1:], i[1:] - 1] = A.cw[:, 1:]
    data[d, i[:-1], i[:-1] + 1] = A.ce[:, :-1]
    data[slot(indptr[1:L]), i, i] = A.cs[1:]
    data[slot(diag_slot[:-1] + 1), i, i] = A.cn[:-1]
    return BSR(data, _index(cols, dev), _index(indptr, dev), (L * n, L * n),
               (n, n))


# -- BSR SpGEMM ---------------------------------------------------------------

def _spgemm_pairs(a_ip, a_ix, b_ip, b_ix, n_brows, n_bcols_out):
    """Symbolic expansion of C = A @ B block pairs, vectorized: for every
    stored block p of A (row i, block column k) and every stored block q of
    B in row k, (p, q, i * n_bcols_out + col(q))."""
    a_rows = np.repeat(np.arange(n_brows, dtype=np.int64), np.diff(a_ip))
    counts = np.diff(b_ip)[a_ix]               # B-row length per A block
    total = int(counts.sum())
    if total == 0:
        return (np.zeros(0, np.int64),) * 3
    a_pair = np.repeat(np.arange(a_ix.shape[0], dtype=np.int64), counts)
    starts = np.repeat(b_ip[a_ix].astype(np.int64), counts)
    run_off = np.repeat(np.cumsum(counts, dtype=np.int64) - counts, counts)
    b_pair = starts + (np.arange(total, dtype=np.int64) - run_off)
    out_key = a_rows[a_pair] * n_bcols_out + b_ix[b_pair].astype(np.int64)
    return a_pair, b_pair, out_key


def bsr_spgemm(A: BSR, B: BSR) -> BSR:
    """C = A @ B for block-sparse matrices: the contributing block pairs
    and the output pattern on the host, then one batched block product
    over all pairs and a segment sum into the output blocks."""
    if A.shape[1] != B.shape[0] or A.blocksize[1] != B.blocksize[0]:
        raise ValueError(f"cannot multiply {A.shape} by {A.blocksize} with "
                         f"{B.shape} by {B.blocksize}")
    bm, _ = A.blocksize
    _, bn = B.blocksize
    n_brows = A.shape[0] // bm
    n_bcols = B.shape[1] // bn
    shape = (A.shape[0], B.shape[1])
    dev = A.device
    a_pair, b_pair, out_key = _spgemm_pairs(
        _host(A.indptr), _host(A.indices), _host(B.indptr),
        _host(B.indices), n_brows, n_bcols)
    dtype = torch.result_type(A.data, B.data)
    if out_key.shape[0] == 0:
        return BSR(torch.zeros((0, bm, bn), dtype=dtype, device=dev),
                   _index([], dev), _index(np.zeros(n_brows + 1), dev),
                   shape, (bm, bn))
    uniq, inv = np.unique(out_key, return_inverse=True)
    indptr = np.zeros(n_brows + 1, np.int64)
    np.add.at(indptr, uniq // n_bcols + 1, 1)

    contrib = torch.bmm(A.data[torch.as_tensor(a_pair, device=dev)],
                        B.data[torch.as_tensor(b_pair, device=dev)])
    data = torch.zeros((uniq.shape[0], bm, bn), dtype=dtype, device=dev)
    data.index_add_(0, torch.as_tensor(inv, device=dev), contrib)
    return BSR(data, _index(uniq % n_bcols, dev),
               _index(np.cumsum(indptr), dev), shape, (bm, bn))
