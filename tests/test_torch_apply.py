"""The one apply body of the port's sweeping preconditioners
(`precond.sweeping.apply_rows`) on the CPU in complex128: for every kind of
state a batch equals its members applied one by one, and a batch of one is
the flat call bit for bit; and its block-Thomas solve against a dense solve,
for diagonal and tridiagonal coupling rows."""
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.precond import recompute, sweeping, sweeping9

N, B, WAVE, CONST, STRIDE = 24, 5, 2.0, 20.0, 4
CD = torch.complex128


@pytest.fixture(scope="module")
def problem():
    cfg = ht.HelmholtzConfig(n=N, b=B, wave_num=WAVE, const=CONST,
                             fidelity="corrected")
    prob = ht.assemble_problem(cfg, "c1_f1", complex_dtype=CD, device="cpu")
    return cfg, prob


def _state(kind, cfg, prob):
    """A factored state of the given kind on the problem."""
    args = (N, B, CONST, cfg.eta, cfg.omega, cfg.h, prob.c_full)
    kw = dict(fidelity="corrected", complex_dtype=CD)
    if kind.startswith("nine"):
        lerp = dict(factor_stride=STRIDE, g_compress=True) \
            if kind == "nine_compressed" else {}
        return sweeping9.setup_preconditioner9(
            fd_stencil.build_a_stencil9(*args, **kw),
            fd_stencil.build_hm_stencils9(*args, **kw), B, device="cpu",
            **lerp)
    if kind == "recompute":
        return recompute.setup_recompute(N, B, WAVE, CONST, 2.0, prob.c_full,
                                         A=prob.A, chunk=7, factor_stride=2)
    if kind == "shared":
        hm = fd_stencil.build_hm_stencils_rows(torch.arange(B, B + 1), *args,
                                               **kw)
        return sweeping.setup_preconditioner(prob.A, hm, B, device="cpu")
    lerp = dict(factor_stride=STRIDE, g_compress=True) \
        if kind == "compressed" else {}
    return sweeping.setup_preconditioner(
        prob.A, fd_stencil.build_hm_stencils(*args, **kw), B, device="cpu",
        **lerp)


def _cplx(rng, *shape):
    return torch.from_numpy(rng.standard_normal(shape)
                            + 1j * rng.standard_normal(shape))


def _rel(got, ref):
    return ((got - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("kind", ["dense", "shared", "compressed",
                                  "nine_dense", "nine_compressed",
                                  "recompute"])
def test_batch_equals_single_applies(problem, kind):
    """`apply_multi` of B = 3 against three flat calls (the batched
    block-Thomas steps are (n, n) @ (n, B) products, the single ones
    matrix-vector products), and a batch of one against the flat call bit
    for bit; the inputs are left as they were."""
    P = _state(kind, *problem)
    L, n = P.grid_shape
    X = _cplx(np.random.default_rng(7), 3, L * n)
    keep = X.clone()
    Y = P.apply_multi(X)
    for k in range(3):
        ref = P(X[k])
        assert _rel(Y[k], ref) < 1e-12, k
        assert torch.equal(P.apply_multi(X[k:k + 1])[0], ref), k
    assert torch.equal(X, keep)


def _coupling_matrix(c):
    """The dense (n, n) matrix of coupling rows c: (n,) diagonal, or (3, n)
    [sub, diag, sup] with sub[0] and sup[-1] left out."""
    if c.ndim == 1:
        return torch.diag(c)
    return (torch.diag(c[1]) + torch.diag(c[0, 1:], -1)
            + torch.diag(c[2, :-1], 1))


@pytest.mark.parametrize("batch", [1, 3])
@pytest.mark.parametrize("rank", [2, 3])
def test_block_thomas_solve_matches_dense(rank, batch):
    """The block-tridiagonal system with diagonal blocks D_l, lower
    couplings c_lo[l] and upper couplings c_up[l], solved from its Schur
    inverses T_l = (D_l - C_lo[l] T_{l-1} C_up[l-1])^{-1}, against a dense
    solve of the assembled matrix; the entries sub[0] and sup[-1] of a
    tridiagonal coupling are not read (NaN here)."""
    L, n = 5, 6
    rng = np.random.default_rng(10 * rank + batch)
    rows = (L, n) if rank == 2 else (L, 3, n)
    c_lo, c_up = _cplx(rng, *rows), _cplx(rng, *rows)
    if rank == 3:
        for c in (c_lo, c_up):
            c[:, 0, 0] = c[:, 2, -1] = float("nan")
    D = _cplx(rng, L, n, n) + 4 * n * torch.eye(n, dtype=CD)
    T = [torch.linalg.inv(D[0])]
    for l in range(1, L):
        T.append(torch.linalg.inv(D[l] - _coupling_matrix(c_lo[l]) @ T[-1]
                                  @ _coupling_matrix(c_up[l - 1])))
    A = torch.zeros((L * n, L * n), dtype=CD)
    for l in range(L):
        here = slice(l * n, (l + 1) * n)
        A[here, here] = D[l]
        if l > 0:
            A[here, here.start - n:here.start] = _coupling_matrix(c_lo[l])
        if l < L - 1:
            A[here, here.stop:here.stop + n] = _coupling_matrix(c_up[l])
    rhs = _cplx(rng, L, batch, n)
    got = sweeping.block_thomas_solve(torch.stack(T), c_lo, c_up, rhs)
    ref = torch.linalg.solve(A, rhs.permute(0, 2, 1).reshape(L * n, batch))
    assert got.shape == (L, batch, n)
    assert _rel(got, ref.reshape(L, n, batch).permute(0, 2, 1)) < 1e-12
