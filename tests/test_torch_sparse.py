"""CPU parity of the port's sparse formats, sparse products, sparse algebra
and exact factorization against the JAX package, in complex128 (complex64
where the Pallas kernel in interpret mode is the reference).  Inputs are
made with numpy from a seed and handed to both sides.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.sparse
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu.core import sparse as jsparse
from helmholtz_tpu.ops import spmv as jspmv
from helmholtz_tpu.ops import sparse_algebra as jsa
from helmholtz_tpu.ops.pallas.bsr_spmm import pallas_bsr_matmat
from helmholtz_tpu.precond import exact as jexact
from helmholtz_tpu_torch import convert
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch.fd.stencil import build_a_stencil as t_build_a_stencil
from helmholtz_tpu_torch.ops import sparse_algebra as tsa
from helmholtz_tpu_torch.ops import spmv as tspmv
from helmholtz_tpu_torch.ops.kernels import bsr_spmm as k4
from helmholtz_tpu_torch.precond import exact as texact

from torch_parity import to_jax, to_np

SPARSE_PRODUCTS = ("bsr_matmat", "bsr_matvec", "coo_matvec", "csr_matmat",
                   "csr_matvec")


def rand_sparse(m, n, density, seed):
    """A random complex matrix with about `density` of its entries set."""
    rng = np.random.default_rng(seed)
    M = scipy.sparse.random(m, n, density=density, random_state=rng)
    M2 = scipy.sparse.random(m, n, density=density, random_state=rng)
    return M.toarray() + 1j * M2.toarray()


def rand_vec(shape, seed, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)


def _close(got, ref, tol, what=""):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * np.abs(ref).max(), err_msg=what)


def _pallas_matrix(bm, bn, seed=3):
    """The block-sparse matrix of the JAX package's Pallas test: about 40%
    of the blocks kept, block row 3 empty, complex64."""
    rng = np.random.default_rng(seed)
    nbr, nbc = 6, 5
    dense = (rng.standard_normal((nbr * bm, nbc * bn))
             + 1j * rng.standard_normal((nbr * bm, nbc * bn)))
    keep = rng.random((nbr, nbc)) < 0.4
    keep[3, :] = False
    keep[0, 0] = True
    blocks = dense.reshape(nbr, bm, nbc, bn) * keep[:, None, :, None]
    return blocks.reshape(nbr * bm, nbc * bn).astype(np.complex64)


@pytest.fixture(scope="module")
def operator():
    """The n = 24 operator of the JAX package's BSR test, assembled by the
    port and carried over to the JAX side (no JAX assembly compiled)."""
    n, b = 24, 4
    h = 1.0 / (n + 1)
    tA = t_build_a_stencil(n, b, 20.0, b * h, 2.0 * np.pi * 2.0 + 2.0j, h,
                           torch.ones((n + 2, n + 2), dtype=torch.float64),
                           complex_dtype=torch.complex128)
    return to_jax(tA), tA


# -- formats ------------------------------------------------------------------

def test_coo_csr_round_trips_match_jax():
    A = rand_sparse(40, 56, 0.1, 0)
    jcoo, jcsr = jsparse.COO.fromdense(A), jsparse.CSR.fromdense(A)
    coo = ht.COO.fromdense(torch.from_numpy(A))
    csr = ht.CSR.fromdense(A, device="cpu")
    for got, ref in ((coo, jcoo), (csr, jcsr)):
        assert got.nnz == ref.nnz and got.shape == ref.shape
        _close(got.todense(), np.asarray(ref.todense()), 0, "todense")
    for name in ("row", "col"):
        np.testing.assert_array_equal(to_np(getattr(coo, name)),
                                      np.asarray(getattr(jcoo, name)))
    for got, ref in ((csr, jcsr), (coo.tocsr(), jcoo.tocsr())):
        for name in ("data", "indices", "indptr"):
            np.testing.assert_array_equal(to_np(getattr(got, name)),
                                          np.asarray(getattr(ref, name)))
    _close(csr.tocoo().todense(), A, 0, "tocoo")
    assert abs(csr.toscipy() - jcsr.toscipy()).max() == 0
    assert csr.indices.dtype == torch.int32 and csr.device.type == "cpu"
    padded = ht.COO.fromdense(torch.from_numpy(A), nnz=coo.nnz + 5)
    assert padded.nnz == coo.nnz + 5
    _close(padded.todense(), A, 0, "padded COO")


def test_bsr_round_trip_matches_jax():
    A = rand_sparse(32, 48, 0.3, 4)
    A[:8, :16] = 0
    jb = jsparse.BSR.fromdense(A, (8, 16))
    tb = ht.BSR.fromdense(torch.from_numpy(A), (8, 16))
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(to_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)))
    assert tb.nnz == jb.nnz and tb.blocksize == (8, 16)
    _close(tb.todense(), A, 0)


def test_stencil_tocsr_matches_jax(operator):
    """Columns ascending, the diagonal always, couplings only inside the
    grid and where non-zero: the JAX package's native layout."""
    jA, tA = operator
    got, ref = tA.tocsr(), jA.tocsr()
    for name in ("indices", "indptr"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))
    _close(got.data, np.asarray(ref.data), 0)
    _close(tA.tocoo().todense(), jA.todense(), 0)


# -- products -----------------------------------------------------------------

def test_coo_and_csr_products_match_jax():
    A = rand_sparse(32, 24, 0.15, 2)
    x, X = rand_vec(24, 1), rand_vec((24, 5), 3)
    jcsr = jsparse.CSR.fromdense(A)
    csr = ht.CSR.fromdense(A, device="cpu")
    tx, tX = torch.from_numpy(x), torch.from_numpy(X)
    _close(tspmv.csr_matvec(csr, tx), jspmv.csr_matvec(jcsr, x), 1e-13)
    _close(tspmv.coo_matvec(csr.tocoo(), tx),
           jspmv.coo_matvec(jcsr.tocoo(), x), 1e-13)
    _close(tspmv.csr_matmat(csr, tX), jspmv.csr_matmat(jcsr, X), 1e-13)
    _close(tspmv.csr_matmat(csr, tX), A @ X, 1e-13, "against dense")


def test_bsr_products_match_jax():
    A = rand_sparse(32, 48, 0.3, 4)
    A[:8, :16] = 0
    jb = jsparse.BSR.fromdense(A, (8, 16))
    tb = ht.BSR.fromdense(A, (8, 16), device="cpu")
    x, X = rand_vec(48, 5), rand_vec((48, 7), 6)
    _close(ht.bsr_matvec(tb, torch.from_numpy(x)),
           jspmv.bsr_matvec(jb, x), 1e-13)
    _close(ht.bsr_matmat(tb, torch.from_numpy(X)),
           jspmv.bsr_matmat(jb, X), 1e-13)


@pytest.mark.parametrize("bm,bn,K", [(8, 8, 16), (8, 12, 3)])
def test_plain_bsr_matches_pallas_kernel_in_interpret_mode(bm, bn, K):
    """The plain version of K4 against the Pallas kernel, on the Pallas
    test's matrix (an empty block row) and with bm != bn; complex64 on
    both sides, float32 sums of 5 * bn products in another order: 1e-5."""
    dense = _pallas_matrix(bm, bn)
    X = rand_vec((dense.shape[1], K), 7, np.complex64)
    ref = pallas_bsr_matmat(jsparse.BSR.fromdense(jnp.asarray(dense),
                                                  (bm, bn)),
                            jnp.asarray(X), interpret=True).to_np()
    A = ht.BSR.fromdense(dense, (bm, bn), device="cpu")
    got = k4.plain_bsr_matmat(A, torch.from_numpy(X))
    _close(got, ref, 1e-5)
    assert not to_np(got)[3 * bm:4 * bm].any()        # the empty block row
    assert A.indptr[4] == A.indptr[3]


def test_bsr_wrapper_takes_its_plain_version_on_the_cpu():
    A = ht.BSR.fromdense(_pallas_matrix(8, 8), (8, 8), device="cpu")
    X = torch.from_numpy(rand_vec((40, 4), 8, np.complex64))
    before = k4.launches
    assert torch.equal(k4.bsr_matmat(A, X), k4.plain_bsr_matmat(A, X))
    assert k4.launches == before


def test_bsr_kernel_contract_is_checked():
    A = ht.BSR.fromdense(_pallas_matrix(8, 8), (8, 8), device="cpu")
    X = torch.zeros((40, 2), dtype=torch.complex64)
    k4.check_kernel_args(A, X)
    bad = [
        (A, torch.zeros((40, 2), dtype=torch.complex128), TypeError),
        (A, torch.zeros((41, 2), dtype=torch.complex64), ValueError),
        (A, torch.zeros((40, 4), dtype=torch.complex64)[:, ::2], ValueError),
        (ht.BSR(A.data, A.indices.long(), A.indptr, A.shape, A.blocksize),
         X, TypeError),
        (ht.BSR(A.data, A.indices, A.indptr, A.shape, (8, 4)), X,
         ValueError),
    ]
    for mat, x, error in bad:
        with pytest.raises(error):
            k4.check_kernel_args(mat, x)


# -- algebra ------------------------------------------------------------------

def test_csr_algebra_matches_jax():
    A, B = rand_sparse(30, 30, 0.1, 10), rand_sparse(30, 30, 0.1, 11)
    jA, jB = jsparse.CSR.fromdense(A), jsparse.CSR.fromdense(B)
    tA = ht.CSR.fromdense(A, device="cpu")
    tB = ht.CSR.fromdense(B, device="cpu")
    got, ref = tsa.csr_add(tA, tB), jsa.csr_add(jA, jB)
    for name in ("indices", "indptr"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))
    _close(got.data, np.asarray(ref.data), 1e-15)
    _close(tsa.csr_add_same_pattern(tA, tsa.csr_scale(tA, 2.0)).todense(),
           np.asarray(jsa.csr_add_same_pattern(
               jA, jsa.csr_scale(jA, 2.0)).todense()), 1e-15)


def test_stencil_to_bsr_and_spgemm_match_jax(operator):
    """The stencil as 3n - 2 layer blocks, and its square: block-pentadiagonal,
    5n - 6 blocks, against the JAX SpGEMM (1e-12 of the largest entry:
    sums of three block products in another order)."""
    jA, tA = operator
    n = tA.grid_shape[1]
    jb, tb = jsa.stencil_to_bsr(jA), tsa.stencil_to_bsr(tA)
    for name in ("data", "indices", "indptr"):
        np.testing.assert_array_equal(to_np(getattr(tb, name)),
                                      np.asarray(getattr(jb, name)))
    got, ref = tsa.bsr_spgemm(tb, tb), jsa.bsr_spgemm(jb, jb)
    assert got.data.shape[0] == 5 * n - 6
    for name in ("indices", "indptr"):
        np.testing.assert_array_equal(to_np(getattr(got, name)),
                                      np.asarray(getattr(ref, name)))
    _close(got.data, np.asarray(ref.data), 1e-12)
    x = torch.from_numpy(rand_vec(n * n, 9))
    _close(ht.bsr_matvec(tb, x), ht.stencil_matvec_flat(tA, x), 1e-13,
           "BSR product against the stencil product")


# -- the exact factorization --------------------------------------------------

@pytest.fixture(scope="module")
def exact31():
    """The n = 31 operator and its exact factorization, both sides."""
    tA = ht.assemble_problem(ht.HelmholtzConfig(
        n=31, b=5, wave_num=2.0, const=20.0), device="cpu").A
    jA = to_jax(tA)
    return jA, jexact.factor_exact(jA), tA, texact.factor_exact(tA)


def test_factor_exact_matches_jax(exact31):
    """31 layer inverses in sequence on both sides (LAPACK on the CPU):
    1e-10 of the largest entry; the converted JAX factorization solves as
    the port's own."""
    jA, jF, tA, tF = exact31
    _close(tF.T, jF.T.to_np(), 1e-10, "T")
    f = rand_vec((31, 31), 12)
    _close(tF.solve(torch.from_numpy(f)), jF.solve(jnp.asarray(f)), 1e-10,
           "solve")
    F2 = convert.exact_factorization_from_numpy(
        jF.T.to_np(), jF.cs.to_np(), jF.cn.to_np(), device="cpu")
    _close(F2(torch.from_numpy(f.reshape(-1))), tF(torch.from_numpy(
        f.reshape(-1))), 1e-10, "converted")


def test_exact_self_checks(exact31):
    """A (A^{-1} I) = I to 1e-9, and L D L' rebuilt by block SpGEMM equal
    to A to 1e-10 of its largest entry (the JAX package's own bounds)."""
    _, _, tA, tF = exact31
    assert texact.rebuild_error(tA, tF) < 1e-9
    scale = np.abs(tA.todense()).max()
    assert texact.rebuild_via_spgemm(tA, tF) < 1e-10 * scale


def test_run_solver_exact_precond():
    """precond="exact" through the driver, with the JAX package's bounds
    for it: at most 2 iterations, true residual below 1e-6."""
    r = tdriver.run_solver(31, 5, 2.0, 20.0, precond="exact", rtol=1e-8,
                           maxiter=20, device="cpu")
    assert r.converged and r.iterations <= 2
    assert r.true_residual < 1e-6
    assert r.config["precond"] == "exact"
    with pytest.raises(ValueError, match="moving_pml"):
        tdriver.run_solver(31, 5, 2.0, 20.0, precond="exact", stencil="9pt",
                           device="cpu")


def test_sparse_converters_and_exports():
    """The converters carry JAX's arrays across; the package exports the
    formats and products the JAX package's top level does."""
    A = rand_sparse(16, 24, 0.3, 13)
    jcsr, jbsr = jsparse.CSR.fromdense(A), jsparse.BSR.fromdense(A, (8, 8))
    csr = convert.csr_from_numpy(jcsr.data, jcsr.indices, jcsr.indptr,
                                 jcsr.shape, device="cpu")
    bsr = convert.bsr_from_numpy(jbsr.data, jbsr.indices, jbsr.indptr,
                                 jbsr.shape, jbsr.blocksize, device="cpu")
    _close(csr.todense(), A, 0)
    _close(bsr.todense(), A, 0)
    assert bsr.indices.dtype == csr.indptr.dtype == torch.int32
    for name in ("COO", "CSR", "BSR") + SPARSE_PRODUCTS:
        assert hasattr(hj, name) and hasattr(ht, name), name
    with pytest.raises(RuntimeError, match="cuda"):
        ht.CSR.fromdense(A)             # numpy input: the card by default
