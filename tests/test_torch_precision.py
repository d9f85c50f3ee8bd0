"""CPU tests of the port's precision path: `solve.ir.ir_gmres` (complex128
solution carry and residual around complex64 GMRES), wired into
`run_solver` and `run_multisolve` as `precision="ir-df32"`, against the JAX
package's double-float32 refinement.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu import driver as jdriver
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch.solve import ir as tir

from torch_parity import random_grid, single_thread, to_np  # noqa: F401

ARGS = (63, 12, 8.0, 61.0)
RTOL = 1e-9


@pytest.fixture(scope="module")
def runs():
    """n = 63 at rtol 1e-9, below the float32 floor of this grid (near
    1e-8): plain complex64, refined complex64 and complex128 in the port,
    and the reference's refined complex64 run."""
    kw = dict(problem="c1_f1", maxiter=60, rtol=RTOL, device="cpu")
    return {
        "plain": tdriver.run_solver(*ARGS, complex_dtype=torch.complex64,
                                    **kw),
        "ir": tdriver.run_solver(*ARGS, complex_dtype=torch.complex64,
                                 precision="ir-df32", **kw),
        "c128": tdriver.run_solver(*ARGS, **kw),
        "jax_ir": jdriver.run_solver(*ARGS, rtol=RTOL, precision="ir-df32",
                                     problem="c1_f1", maxiter=60,
                                     complex_dtype=jnp.complex64),
    }


def test_ir_gmres_beats_f32_floor_in_complex64(runs):
    """The refined solve converges where plain complex64 GMRES stalls, with
    a count within +1 of the complex128 run."""
    assert not runs["plain"].converged
    assert runs["ir"].converged and runs["c128"].converged
    assert runs["ir"].iterations <= runs["c128"].iterations + 1
    assert runs["ir"].residual_norm < runs["plain"].residual_norm
    assert runs["ir"].config["precision"] == "ir-df32"
    assert runs["ir"].config["dtype"] == "complex64"
    assert runs["ir"].u.dtype == np.complex64


def test_ir_gmres_matches_jax_count_and_history(runs):
    """Equal iteration counts (6 and 6 here), held to +-1 because both runs
    round in float32 in different orders and a residual may land on either
    side of a cycle's tolerance; the history, which both concatenate at the
    running count, to 5% over the common part for the same reason."""
    r_t, r_j = runs["ir"], runs["jax_ir"]
    assert r_j.converged
    assert abs(r_t.iterations - r_j.iterations) <= 1
    k = min(r_t.iterations, r_j.iterations)
    assert np.all(np.isfinite(r_t.history[:r_t.iterations]))
    np.testing.assert_allclose(r_t.history[:k], r_j.history[:k], rtol=5e-2)
    assert r_t.history[r_t.iterations - 1] < r_t.history[0]
    np.testing.assert_allclose(r_t.u, r_j.u, rtol=1e-5,
                               atol=1e-5 * np.abs(r_j.u).max())


def test_ir_gmres_complex128_matches_jax_exactly():
    """With complex128 as the working type rounding is out of the way, so
    the refinement's own rules (the stall test, the remaining budget given
    to each cycle, where a cycle's history lands) are held exactly: equal
    counts and flags, and u to 1e-10, over the refinement cycles that rtol
    1e-9 takes at n = 33.  The history is held to 1e-7: its last entries
    lie eight orders below the first, and a later cycle starts from a
    residual that each package rounded in its own order (observed 1.7e-8
    on one entry, below 1e-9 on the others)."""
    args = (33, 6, 4.0, 30.0)
    kw = dict(problem="c1_f1", rtol=1e-9, precision="ir-df32", maxiter=60)
    r_j = jdriver.run_solver(*args, **kw)
    r_t = tdriver.run_solver(*args, device="cpu", **kw)
    assert r_t.config["dtype"] == "complex128" == r_j.config["dtype"]
    assert r_t.converged and r_j.converged
    assert r_t.iterations == r_j.iterations >= 5
    assert r_t.history.shape == r_j.history.shape
    np.testing.assert_allclose(r_t.history, r_j.history, rtol=1e-7,
                               equal_nan=True)
    # the final norm is of a recomputed b - A x nine orders below b, where
    # the subtraction's own rounding shows (observed 6.7e-6)
    np.testing.assert_allclose(r_t.residual_norm, r_j.residual_norm,
                               rtol=1e-4)
    np.testing.assert_allclose(r_t.u, r_j.u, rtol=1e-10,
                               atol=1e-10 * np.abs(r_j.u).max())


def _diag_problem(K, dtype=torch.complex64):
    rng = np.random.default_rng(11)
    d = rng.uniform(1.0, 2.0, 40) + 1j * rng.uniform(-0.5, 0.5, 40)
    B = random_grid(12, (K, 40))
    d_lo = torch.from_numpy(d).to(dtype)
    mv = lambda V: d_lo * V
    mv_hi = lambda V: d_lo.to(torch.complex128) * V
    return d_lo, torch.from_numpy(B).to(dtype), mv, mv_hi


def test_ir_gmres_semantics_on_a_small_system():
    """A diagonal complex64 system solved below the float32 floor: the
    history of the cycles is concatenated at the running count, the count
    never passes maxiter, and a cycle that does not reduce the residual
    stops the member (`breakdown`)."""
    d, B, mv, mv_hi = _diag_problem(1)
    kw = dict(restart=5, maxiter=40, device="cpu")
    res = tir.ir_gmres(lambda v: d * v, lambda v: d.to(v.dtype) * v, B[0],
                       rtol=1e-12, **kw)
    assert res.converged and not res.breakdown
    assert isinstance(res.iterations, int) and res.x.dtype == torch.complex64
    assert res.history.shape == (40 * 12,)
    assert np.isfinite(res.history[:res.iterations]).all()
    assert np.isnan(res.history[res.iterations:]).all()
    # against the complex128 solution of the SAME complex64 operator
    exact = B[0].to(torch.complex128) / d.to(torch.complex128)
    err = (res.x.to(torch.complex128) - exact).abs().max() / exact.abs().max()
    assert err < 2e-7                    # x is rounded to complex64 once
    plain = ht.gmres(lambda v: d * v, B[0], rtol=1e-12, **kw)
    assert not plain.converged
    capped = tir.ir_gmres(lambda v: d * v, lambda v: d.to(v.dtype) * v, B[0],
                          rtol=1e-12, restart=5, maxiter=7, device="cpu")
    assert capped.iterations <= 7 and not capped.converged
    # a residual that cannot fall (the high-precision operator is another
    # one) stalls after its second cycle instead of spinning
    stuck = tir.ir_gmres(lambda v: d * v, lambda v: 2.0 * d.to(v.dtype) * v,
                         B[0], rtol=1e-12, **kw)
    assert stuck.breakdown and not stuck.converged


def test_ir_gmres_batched_equals_single_solves():
    """Members of a lockstep refined batch are their single refined solves:
    exact counts and flags, x to float32 rounding."""
    d, B, mv, mv_hi = _diag_problem(3)
    B[1] *= 1e-3
    B[2, 1:] = 0                                   # solved in one step
    kw = dict(rtol=1e-11, restart=4, maxiter=40, device="cpu")
    res = tir.ir_gmres_batched(mv, mv_hi, B, **kw)
    assert res.converged.all()
    assert len(set(res.iterations.tolist())) > 1
    for p in range(3):
        single = tir.ir_gmres(mv, mv_hi, B[p], **kw)
        assert res.iterations[p] == single.iterations
        assert res.converged[p] == single.converged
        assert res.breakdown[p] == single.breakdown
        np.testing.assert_allclose(res.history[p], single.history,
                                   rtol=1e-4, equal_nan=True)
        np.testing.assert_allclose(to_np(res.x[p]), to_np(single.x),
                                   rtol=1e-6, atol=1e-9)


def test_run_multisolve_refined_converges_past_the_floor():
    """`precision="ir-df32"` and `precond_refine` on the batched driver, in
    complex64 at rtol 1e-7 on a 31 x 31 grid: every source converges where
    the plain complex64 batch does not, in no more iterations than the
    complex128 batch needs without them, plus one."""
    args = (31, 6, [4.0])
    kw = dict(consts=[30.0], n_sources=2, rtol=1e-7, maxiter=40,
              device="cpu")
    c64 = dict(complex_dtype=torch.complex64, **kw)
    [rec] = tdriver.run_multisolve(*args, precision="ir-df32",
                                   precond_refine=1, **c64)
    [plain] = tdriver.run_multisolve(*args, **c64)
    [oracle] = tdriver.run_multisolve(*args, **kw)
    assert rec["converged"] == [True, True] == oracle["converged"]
    assert plain["converged"] == [False, False]
    assert rec["precision"] == "ir-df32" and rec["precond_refine"] == 1
    assert rec["dtype"] == "complex64" and oracle["dtype"] == "complex128"
    assert set(rec) == set(plain)
    assert all(a <= b + 1 for a, b in zip(rec["iterations"],
                                          oracle["iterations"]))
    assert all(a < b for a, b in zip(rec["true_residuals"],
                                     plain["true_residuals"]))
    with pytest.raises(ValueError, match="precision"):
        tdriver.run_multisolve(*args, precision="f64", **kw)


def test_matvec_hi_is_the_complex128_product_of_the_complex64_operator():
    cfg = ht.HelmholtzConfig(n=17, b=4, wave_num=1.0, const=20.0)
    A = ht.assemble_problem(cfg, complex_dtype=torch.complex64,
                            device="cpu").A
    x = random_grid(13, (2, 17 * 17))
    got = to_np(tdriver._matvec_hi(A)(torch.from_numpy(x)))
    assert got.dtype == np.complex128
    fields = [f.astype(np.complex128) for f in A.to_numpy()]
    for p in range(2):
        ref = tdriver._host_stencil_matvec(fields, x[p].reshape(17, 17))
        np.testing.assert_allclose(got[p].reshape(17, 17), ref, rtol=1e-14,
                                   atol=1e-14 * np.abs(ref).max())
