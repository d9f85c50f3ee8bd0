"""Batched dense complex linear algebra.

The Schur complements inverted by the preconditioner setup are
complex-shifted, PML-damped Helmholtz blocks, far from needing global
pivoting.  On the card `batched_inverse` therefore runs the JAX package's
blocked Gauss-Jordan without cross-panel pivoting: panels 256 wide, then 64
wide, and on panels of 64 or fewer the Gauss-Jordan kernel
(`ops.kernels.gj_inverse`, K3); the three panel products of each step are
batched complex64 matrix products in full float32; any other type reaches
the kernel's argument check and raises.  On the CPU and with `pivoted=True`
it calls `torch.linalg.inv` (pivoted LU), as the JAX package calls LAPACK on
the CPU.

`batched_inverse_sym` is the route for complex-symmetric batches (A^T = A,
as every layer Schur block of the 5-point recursion): the same blocked
Gauss-Jordan, panel for panel, that reads A's lower triangle only and skips
the products the symmetry makes redundant (`_blocked_gj_sym`).
`inverses_by_route` counts the matrices each unpivoted route takes.
"""
from __future__ import annotations

import math

import torch

from .kernels.gj_inverse import gj_inverse


#: matrices taken by each unpivoted route in this process: "general"
#: (`batched_inverse`) and "sym" (`batched_inverse_sym`); on the card these
#: are the matrices each route inverts, on the CPU both are `torch.linalg.inv`
inverses_by_route = {"sym": 0, "general": 0}


def reset_counts() -> None:
    for route in inverses_by_route:
        inverses_by_route[route] = 0


def batched_inverse(A: torch.Tensor, *, block: int = 256,
                    pivoted: bool = False) -> torch.Tensor:
    """Inverse of a batch of square matrices (..., n, n)."""
    if not pivoted:
        inverses_by_route["general"] += math.prod(A.shape[:-2])
    if pivoted or A.device.type != "cuda":
        return torch.linalg.inv(A)
    n = A.shape[-1]
    X = _blocked_gj(A.reshape(-1, n, n), block)
    return X.reshape(A.shape)


def batched_inverse_sym(A: torch.Tensor) -> torch.Tensor:
    """Inverse of a batch of complex-symmetric matrices (..., n, n).

    On the card `_blocked_gj_sym`, which reads only the lower triangle of A
    and returns an exactly symmetric inverse; on the CPU `torch.linalg.inv`
    of A as given, as `batched_inverse`.  For a matrix symmetric only to
    rounding, reading the lower triangle is the whole difference from the
    general route."""
    inverses_by_route["sym"] += math.prod(A.shape[:-2])
    if A.device.type != "cuda":
        return torch.linalg.inv(A)
    n = A.shape[-1]
    X = _blocked_gj_sym(A.reshape(-1, n, n), 256)
    return X.reshape(A.shape)


def blocked_gj_flops(n: int, block: int = 256, *,
                     symmetric: bool = False) -> float:
    """Float32 operations (8 a complex multiply-add) of one n x n matrix
    through `_blocked_gj`, or `_blocked_gj_sym` if `symmetric`, padding
    included, the scalar base case at 8 k^3."""
    if n <= 64:
        return 8.0 * n ** 3
    nb = min(block, max(64, -(-n // 2)))
    n_pad = -(-n // nb) * nb
    N = n_pad // nb
    if symmetric:
        macs = nb * nb * (n_pad - nb) + (N - 1) * N // 2 * nb ** 3
    else:
        macs = nb * nb * n_pad + n_pad * n_pad * nb + n_pad * nb * nb
    return N * (blocked_gj_flops(nb, max(64, nb // 4)) + 8.0 * macs)


def _blocked_gj(A: torch.Tensor, block: int) -> torch.Tensor:
    """Blocked Gauss-Jordan inverse of a (B, n, n) batch, the recursion of
    the JAX package's `_blocked_gj`: panel width min(block, max(64,
    ceil(n/2))), inner panels max(64, nb // 4), an identity tail padding n
    to a multiple of the panel, and at n <= 64 the scalar Gauss-Jordan (the
    kernel on the card, its plain version on the CPU).  Returns a (B, n, n)
    tensor, a view into the padded work matrix when n was padded."""
    B, n, _ = A.shape
    if n <= 64:
        return gj_inverse(A.contiguous())
    nb = min(block, max(64, -(-n // 2)))
    n_pad = -(-n // nb) * nb
    X = torch.zeros((B, n_pad, n_pad), dtype=A.dtype, device=A.device)
    X[:, :n, :n] = A
    X[:, n:, n:].diagonal(dim1=-2, dim2=-1).fill_(1)
    for kb in range(0, n_pad, nb):
        panel = slice(kb, kb + nb)
        P = _blocked_gj(X[:, panel, panel], max(64, nb // 4))
        rowk = torch.bmm(P, X[:, panel, :])                    # (B, nb, n)
        colk = X[:, :, panel].clone()                         # (B, n, nb)
        X.baddbmm_(colk, rowk, alpha=-1)
        X[:, :, panel] = torch.bmm(colk, P).neg_()
        X[:, panel, :] = rowk
        X[:, panel, panel] = P
        del P, rowk, colk
    return X[:, :n, :n] if n_pad != n else X


#: rows of the batch that one block-row product of `_blocked_gj_sym` should
#: cover at least: below it the products are grouped (see there)
SYM_PRODUCT_ROWS = 2048


def _mirror_lower_(X: torch.Tensor) -> torch.Tensor:
    """X = tril(X) + tril(X, -1)^T in place, on a (..., m, m) view, through
    one (..., m, m) temporary."""
    m = X.shape[-1]
    lower = torch.ones((m, m), dtype=torch.bool, device=X.device).tril_()
    return X.copy_(torch.where(lower, X, X.mT))


def _diagonal_blocks(X: torch.Tensor, nb: int) -> torch.Tensor:
    """The (B, N, nb, nb) view of the diagonal panels of a contiguous
    (B, N nb, N nb) matrix."""
    B, n, _ = X.shape
    return X.as_strided((B, n // nb, nb, nb),
                        (n * n, (n + 1) * nb, n, 1), X.storage_offset())


def _blocked_gj_sym(A: torch.Tensor, block: int) -> torch.Tensor:
    """Blocked Gauss-Jordan inverse of a complex-symmetric (B, n, n) batch
    from its lower triangle: the panel widths, identity tail, panel order
    and unpivoted arithmetic of `_blocked_gj`, each panel's own inverse
    through `_blocked_gj` (so K3 is reached as there).

    Unpivoted Gauss-Jordan on a symmetric matrix keeps X^T = J X J after
    every panel, J = +1 on the indices of the panels done and -1 on the
    rest.  So only the lower block triangle (diagonal panels whole) is
    kept, the strictly upper panels are never read, and at step k
    (K = the panel, P = X_KK^-1, W = X_K,<K the panel's row left of it, V =
    X_>K,K its column below it):

        rowk = [P W, P V^T]           (X_K,>K = V^T by the invariant)
        X_ij += W_i^T rowk_j          i, j < K, j <= i  (colk_i = -W_i^T)
        X_ij -= V_i rowk_j            i > K, j <= i, j != K
        X_K,<K = P W;  X_>K,K = -(P V^T)^T;  X_KK = P

    The panel column is the signed transpose of rowk: the general route's
    `colk @ P` product and its `colk` copy are gone, and the rank-nb update
    covers (N - 1) N / 2 panels of nb^2 (N = n_pad / nb) in place of N^2.
    Operations per matrix (`blocked_gj_flops`), in complex multiply-adds:
    N (nb^2 (n_pad - nb) + (N - 1) N nb^3 / 2) and N panel inverses of
    1.6 nb^3, so 0.66 n^3 at n = 1023 (N = 4) and 0.57 n^3 at n = 2047
    (N = 8), against the general route's 1.60 n^3 and 1.28 n^3 (panel
    inverses included in both).  Bound: the float32 FMA rate of the card's
    batched complex products, as the general route.

    Shape-chosen grouping: the update runs as one product per group of g
    block rows over the columns up to the group's last diagonal panel (the
    strictly upper panels inside a group are written and never read),
    g = ceil(SYM_PRODUCT_ROWS / (B nb)) capped at N.  For the setup's
    batches (B >= 8 at nb = 256) g = 1 and every product is exactly the
    lower triangle's; at a batch of one (H_F's stack, one-subgrid setups)
    the inverse is bound by the host's launches, not by the card, and
    g = N gives each of the three update regions one product a step: as
    many launches a step as the general route, the mirrors adding N + 5.

    The lower triangle is mirrored to the upper once, at the end.
    Workspace: the padded work matrix, rowk (B, nb, n_pad) and one
    (B, n_pad, nb) temporary for the diagonal panels' mirror, against the
    general route's rowk, colk and colk @ P.  Returns a (B, n, n) tensor,
    a view into the padded work matrix when n was padded."""
    B, n, _ = A.shape
    if n <= 64:
        return _mirror_lower_(gj_inverse(_mirror_lower_(A.clone())))
    nb = min(block, max(64, -(-n // 2)))
    n_pad = -(-n // nb) * nb
    N = n_pad // nb
    g = min(N, -(-SYM_PRODUCT_ROWS // (B * nb)))
    X = torch.zeros((B, n_pad, n_pad), dtype=A.dtype, device=A.device)
    X[:, :n, :n] = A
    X[:, n:, n:].diagonal(dim1=-2, dim2=-1).fill_(1)
    _mirror_lower_(_diagonal_blocks(X, nb))
    for k in range(N):
        lo, hi = k * nb, (k + 1) * nb
        P = _blocked_gj(X[:, lo:hi, lo:hi], max(64, nb // 4))
        W = X[:, lo:hi, :lo]                                  # (B, nb, lo)
        V = X[:, hi:, lo:hi]                                  # (B, ., nb)
        row_l = torch.bmm(P, W)
        row_r = torch.bmm(P, V.mT)
        for i in range(0, k, g):
            r = slice(i * nb, min(i + g, k) * nb)
            X[:, r, :r.stop].baddbmm_(W[:, :, r].mT, row_l[:, :, :r.stop])
        if 0 < lo and hi < n_pad:
            X[:, hi:, :lo].baddbmm_(V, row_l, alpha=-1)
        for i in range(k + 1, N, g):
            r = slice(i * nb - hi, min(i + g, N) * nb - hi)
            X[:, hi + r.start:hi + r.stop, hi:hi + r.stop].baddbmm_(
                V[:, r], row_r[:, :, :r.stop], alpha=-1)
        X[:, lo:hi, :lo] = row_l
        torch.neg(row_r.mT, out=X[:, hi:, lo:hi])
        X[:, lo:hi, lo:hi] = P
        del P, row_l, row_r
    for k in range(N - 1):
        lo, hi = k * nb, (k + 1) * nb
        X[:, lo:hi, hi:] = X[:, hi:, lo:hi].mT
    _mirror_lower_(_diagonal_blocks(X, nb))
    return X[:, :n, :n] if n_pad != n else X
