"""Sparse matrix containers: the 5-point stencil as five coefficient fields
("DIA by grid geometry"), the 9-point stencil as nine, and the generic COO,
CSR and BSR formats as dataclasses of tensors.  Counterparts of the
classes of the JAX package's `core/sparse.py`.

The generic formats keep their index arrays as int32 tensors on the device
of their values.  Conversions that decide a sparsity pattern (`fromdense`,
`tocsr`) run on the host in numpy, as in the JAX package, and put the
result on the device asked for.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from .._device import resolve_device


@dataclasses.dataclass(frozen=True)
class Stencil5:
    """5-point stencil operator on an (L, n) grid of unknowns.

    Vector index k = j*n + i for layer j (x2 direction) and in-layer
    position i (x1 direction), both 0-based.

    Fields, all complex tensors of shape (..., L, n), zero where the coupling
    would leave the grid (Dirichlet boundaries):
      cc : diagonal coefficient
      cw : coupling to (j, i-1)
      ce : coupling to (j, i+1)
      cs : coupling to (j-1, i)
      cn : coupling to (j+1, i)
    """

    cc: torch.Tensor
    cw: torch.Tensor
    ce: torch.Tensor
    cs: torch.Tensor
    cn: torch.Tensor

    def fields(self):
        return (self.cc, self.cw, self.ce, self.cs, self.cn)

    def map(self, fn) -> "Stencil5":
        """A new Stencil5 with `fn` applied to every field."""
        return Stencil5(*(fn(f) for f in self.fields()))

    @property
    def grid_shape(self) -> tuple[int, int]:
        return self.cc.shape[-2], self.cc.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        N = self.cc.shape[-1] * self.cc.shape[-2]
        return (N, N)

    @property
    def nnz(self) -> int:
        """Stored-structure nonzeros: 5*L*n minus the masked boundary slots
        (5n^2-4n when L == n)."""
        L, n = self.grid_shape
        return 5 * L * n - 2 * L - 2 * n

    @property
    def dtype(self) -> torch.dtype:
        return self.cc.dtype

    @property
    def device(self) -> torch.device:
        return self.cc.device

    def to_numpy(self):
        """The five fields as host numpy arrays (cc, cw, ce, cs, cn)."""
        return tuple(f.detach().cpu().numpy() for f in self.fields())

    def todense(self) -> np.ndarray:
        """Dense (N, N) matrix: host-side test/oracle helper."""
        L, n = self.grid_shape
        N = L * n
        cc, cw, ce, cs, cn = self.to_numpy()
        A = np.zeros((N, N), dtype=cc.dtype)
        k = np.arange(N)
        A[k, k] = cc.reshape(-1)
        A[k[1:], k[1:] - 1] = cw.reshape(-1)[1:]
        A[k[:-1], k[:-1] + 1] = ce.reshape(-1)[:-1]
        A[k[n:], k[n:] - n] = cs.reshape(-1)[n:]
        A[k[:-n], k[:-n] + n] = cn.reshape(-1)[:-n]
        return A

    def toscipy(self):
        """scipy CSR: host-side oracle helper."""
        import scipy.sparse

        L, n = self.grid_shape
        cc, cw, ce, cs, cn = (f.reshape(-1) for f in self.to_numpy())
        return scipy.sparse.diags(
            [cc, cw[1:], ce[:-1], cs[n:], cn[:-n]],
            [0, -1, 1, -n, n],
            format="csr",
        )

    def tocsr(self) -> "CSR":
        """CSR with the columns of each row in ascending order: the diagonal
        always, a coupling only where it lies inside the grid and is not
        zero.  Built on the host with numpy, never through a dense matrix;
        on the fields' device."""
        L, n = self.grid_shape
        cc, cw, ce, cs, cn = (f.reshape(-1) for f in self.to_numpy())
        k = np.arange(L * n)
        j, i = np.divmod(k, n)
        # candidate entries of each row in column order: -n, -1, 0, +1, +n
        vals = np.stack([cs, cw, cc, ce, cn], axis=1)
        cols = k[:, None] + np.array([-n, -1, 0, 1, n])
        keep = np.stack([(j > 0) & (cs != 0), (i > 0) & (cw != 0),
                         np.ones(L * n, bool), (i < n - 1) & (ce != 0),
                         (j < L - 1) & (cn != 0)], axis=1)
        indptr = np.concatenate([[0], np.cumsum(keep.sum(axis=1))])
        dev = self.device
        return CSR(torch.as_tensor(vals[keep], device=dev),
                   _index(cols[keep], dev), _index(indptr, dev), self.shape)

    def tocoo(self) -> "COO":
        return self.tocsr().tocoo()


@dataclasses.dataclass(frozen=True)
class Stencil9:
    """9-point stencil operator: Stencil5 plus the four diagonal couplings.

    Fields as in `Stencil5`, and
      csw : coupling to (j-1, i-1)
      cse : coupling to (j-1, i+1)
      cnw : coupling to (j+1, i-1)
      cne : coupling to (j+1, i+1)
    Offsets in flat ordering: 0, +-1, +-n, +-(n-1), +-(n+1).
    """

    cc: torch.Tensor
    cw: torch.Tensor
    ce: torch.Tensor
    cs: torch.Tensor
    cn: torch.Tensor
    csw: torch.Tensor
    cse: torch.Tensor
    cnw: torch.Tensor
    cne: torch.Tensor

    #: (dj, di) of each field, in field order
    OFFSETS = ((0, 0), (0, -1), (0, 1), (-1, 0), (1, 0),
               (-1, -1), (-1, 1), (1, -1), (1, 1))

    def fields(self):
        return (self.cc, self.cw, self.ce, self.cs, self.cn,
                self.csw, self.cse, self.cnw, self.cne)

    def map(self, fn) -> "Stencil9":
        """A new Stencil9 with `fn` applied to every field."""
        return Stencil9(*(fn(f) for f in self.fields()))

    @property
    def grid_shape(self) -> tuple[int, int]:
        return self.cc.shape[-2], self.cc.shape[-1]

    @property
    def shape(self) -> tuple[int, int]:
        N = self.cc.shape[-1] * self.cc.shape[-2]
        return (N, N)

    @property
    def dtype(self) -> torch.dtype:
        return self.cc.dtype

    @property
    def device(self) -> torch.device:
        return self.cc.device

    def to_numpy(self):
        """The nine fields as host numpy arrays, in field order."""
        return tuple(f.detach().cpu().numpy() for f in self.fields())

    def todense(self) -> np.ndarray:
        """Dense (N, N) matrix: host-side test/oracle helper."""
        L, n = self.grid_shape
        A = np.zeros((L * n, L * n), dtype=self.to_numpy()[0].dtype)
        j, i = np.divmod(np.arange(L * n), n)
        for f, (dj, di) in zip(self.to_numpy(), self.OFFSETS):
            ok = ((j + dj >= 0) & (j + dj < L) & (i + di >= 0)
                  & (i + di < n))
            k = np.flatnonzero(ok)
            A[k, k + dj * n + di] = f.reshape(-1)[k]
        return A


def _target_device(A, device):
    """The device of a `fromdense` result: the one asked for, else the
    input tensor's, else the card."""
    if device is None:
        device = A.device if isinstance(A, torch.Tensor) else "cuda"
    return resolve_device(device)


def _host(A) -> np.ndarray:
    return (A.detach().cpu().numpy() if isinstance(A, torch.Tensor)
            else np.asarray(A))


def _index(a, device) -> torch.Tensor:
    """An int32 index tensor (a copy) on `device` from host indices."""
    return torch.tensor(np.asarray(a), dtype=torch.int32, device=device)


def _rows_of(indptr: torch.Tensor, count: int) -> torch.Tensor:
    """The row (or block row) of every stored entry, from indptr."""
    nrows = indptr.shape[0] - 1
    return torch.repeat_interleave(
        torch.arange(nrows, dtype=torch.int64, device=indptr.device),
        torch.diff(indptr).to(torch.int64), output_size=count)


@dataclasses.dataclass(frozen=True)
class COO:
    """Coordinate-format sparse matrix."""

    data: torch.Tensor   # (nnz,)
    row: torch.Tensor    # (nnz,) int32
    col: torch.Tensor    # (nnz,) int32
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def fromdense(cls, A, nnz: int | None = None, *, device=None) -> "COO":
        """The nonzeros of a dense matrix (tensor or numpy array) in row-major
        order; `nnz` pads the arrays with zero entries at (0, 0) to a fixed
        length."""
        dev = _target_device(A, device)
        A = _host(A)
        r, c = np.nonzero(A)
        d = A[r, c]
        if nnz is not None:
            pad = nnz - d.shape[0]
            d, r, c = (np.pad(x, (0, pad)) for x in (d, r, c))
        return cls(torch.as_tensor(d, device=dev), _index(r, dev),
                   _index(c, dev), tuple(A.shape))

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.row.long(), self.col.long()), self.data,
                              accumulate=True)

    def tocsr(self) -> "CSR":
        row, col = _host(self.row), _host(self.col)
        order = np.lexsort((col, row))
        indptr = np.zeros(self.shape[0] + 1, np.int64)
        np.add.at(indptr, row[order] + 1, 1)
        perm = torch.as_tensor(order, device=self.device)
        return CSR(self.data[perm], _index(col[order], self.device),
                   _index(np.cumsum(indptr), self.device), self.shape)


@dataclasses.dataclass(frozen=True)
class CSR:
    """Compressed-sparse-row matrix."""

    data: torch.Tensor     # (nnz,)
    indices: torch.Tensor  # (nnz,) int32 column indices
    indptr: torch.Tensor   # (nrows + 1,) int32
    shape: tuple

    @property
    def nnz(self) -> int:
        return self.data.shape[0]

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def fromdense(cls, A, *, device=None) -> "CSR":
        return COO.fromdense(A, device=device).tocsr()

    def rows(self) -> torch.Tensor:
        """The row of every stored entry (int64)."""
        return _rows_of(self.indptr, self.nnz)

    def todense(self) -> torch.Tensor:
        out = torch.zeros(self.shape, dtype=self.dtype, device=self.device)
        return out.index_put_((self.rows(), self.indices.long()), self.data,
                              accumulate=True)

    def tocoo(self) -> COO:
        return COO(self.data, self.rows().to(torch.int32), self.indices,
                   self.shape)

    def toscipy(self):
        import scipy.sparse

        return scipy.sparse.csr_matrix(
            (_host(self.data), _host(self.indices), _host(self.indptr)),
            shape=self.shape)


@dataclasses.dataclass(frozen=True)
class BSR:
    """Block-sparse-row matrix: CSR over dense (bm, bn) blocks, stored in
    CSR order (the blocks of a block row are consecutive)."""

    data: torch.Tensor     # (nblocks, bm, bn)
    indices: torch.Tensor  # (nblocks,) int32 block-column indices
    indptr: torch.Tensor   # (n_block_rows + 1,) int32
    shape: tuple
    blocksize: tuple

    @property
    def nnz(self) -> int:
        return self.data.numel()

    @property
    def dtype(self) -> torch.dtype:
        return self.data.dtype

    @property
    def device(self) -> torch.device:
        return self.data.device

    @classmethod
    def fromdense(cls, A, blocksize, *, device=None) -> "BSR":
        """The blocks of a dense matrix that hold a nonzero."""
        dev = _target_device(A, device)
        A = _host(A)
        bm, bn = blocksize
        M, N = A.shape
        if M % bm or N % bn:
            raise ValueError(f"blocksize {blocksize} does not divide the "
                             f"shape {A.shape}")
        blocks = A.reshape(M // bm, bm, N // bn, bn).transpose(0, 2, 1, 3)
        br, bc = np.nonzero(np.abs(blocks).sum(axis=(2, 3)) != 0)
        indptr = np.zeros(M // bm + 1, np.int64)
        np.add.at(indptr, br + 1, 1)
        return cls(torch.as_tensor(np.ascontiguousarray(blocks[br, bc]),
                                   device=dev),
                   _index(bc, dev), _index(np.cumsum(indptr), dev), (M, N),
                   (bm, bn))

    def block_rows(self) -> torch.Tensor:
        """The block row of every stored block (int64)."""
        return _rows_of(self.indptr, self.data.shape[0])

    def todense(self) -> torch.Tensor:
        bm, bn = self.blocksize
        M, N = self.shape
        out = torch.zeros((M // bm, N // bn, bm, bn), dtype=self.dtype,
                          device=self.device)
        out.index_put_((self.block_rows(), self.indices.long()), self.data,
                       accumulate=True)
        return out.transpose(1, 2).reshape(M, N)
