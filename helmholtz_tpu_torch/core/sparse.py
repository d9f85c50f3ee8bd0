"""Structured operator containers: the 5-point stencil as five coefficient
fields ("DIA by grid geometry") and the 9-point stencil as nine.
Counterparts of `Stencil5` and `Stencil9` in the JAX package's
`core/sparse.py`; the generic COO/CSR/BSR formats are not ported yet.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


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
