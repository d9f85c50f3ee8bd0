"""CPU parity of the port's BiCGStab (`solve.bicgstab`) against the JAX
package's, in complex128: the plain solver against a direct solve, the
preconditioned solver against JAX `bicgstab` (equal counts, x and history
to 1e-10), the lockstep batch against its single solves, and `run_solver(
method="bicgstab")` on both stencils against the JAX driver's count."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu import driver as jdriver
from helmholtz_tpu.core.complexlib import CArray
from helmholtz_tpu.ops.spmv import stencil_matvec_flat as j_matvec_flat
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.solve import batched as tbatched

from torch_parity import port_problems, random_grid, to_np  # noqa: F401

N, B, WAVE, CONST = 33, 6, 2.0, 20.0


@pytest.fixture(scope="module")
def problem():
    """(JAX problem, port problem, port preconditioner, the same state as
    a JAX preconditioner): the JAX side holds the port's own arrays."""
    _, jprob, _, tprob, thm = port_problems(N, B, WAVE, CONST)
    P_t = tsweep.setup_preconditioner(tprob.A, thm, B, device="cpu")
    pair = lambda t: CArray.of(jnp.asarray(to_np(t)))         # noqa: E731
    G = lambda t: jnp.asarray(to_np(t)[:, :, :N])              # noqa: E731
    P_j = jsweep.SweepingPreconditioner(
        G=CArray(G(P_t.G_re), G(P_t.G_im)), TF=pair(P_t.TF),
        hf_cs=pair(P_t.hf_cs), hf_cn=pair(P_t.hf_cn), a_cs=pair(P_t.a_cs),
        a_cn=pair(P_t.a_cn), b=B, d2_replace=True)
    return jprob, tprob, P_t, P_j


def test_bicgstab_matches_direct():
    """A 100 x 100 random diagonally boosted system, as the JAX package's
    own test: x to 1e-6 of the direct solve at rtol 1e-10."""
    rng = np.random.default_rng(0)
    A = (rng.standard_normal((100, 100))
         + 1j * rng.standard_normal((100, 100)))
    A = A + 4.0 * np.sqrt(100) * np.eye(100)
    b = rng.standard_normal(100) + 1j * rng.standard_normal(100)
    A_t = torch.from_numpy(A)
    res = ht.bicgstab(lambda v: A_t @ v, torch.from_numpy(b), rtol=1e-10,
                      maxiter=500, device="cpu")
    assert res.converged and not res.breakdown
    assert res.history.shape == (500,)
    np.testing.assert_allclose(to_np(res.x), np.linalg.solve(A, b),
                               rtol=1e-6)


def test_bicgstab_with_sweeping_matches_jax(problem):
    """Preconditioned by the sweep, at rtol 1e-10: the same iteration count
    and flags as JAX `bicgstab`, x and the history within 1e-10."""
    jprob, tprob, P_t, P_j = problem
    f = to_np(tprob.f_grid).reshape(-1)
    kw = dict(rtol=1e-10, maxiter=40)
    r_j = hj.bicgstab(lambda v: j_matvec_flat(jprob.A, v), jnp.asarray(f),
                      M=P_j, **kw)
    r_t = ht.bicgstab(lambda v: ht.stencil_matvec_flat(tprob.A, v),
                      torch.from_numpy(f.copy()), M=P_t, device="cpu", **kw)
    assert r_t.converged and bool(r_j.converged)
    assert r_t.iterations == int(r_j.iterations) >= 3
    assert r_t.breakdown == bool(r_j.breakdown)
    h_j = np.asarray(r_j.history)
    np.testing.assert_array_equal(np.isnan(r_t.history), np.isnan(h_j))
    np.testing.assert_allclose(r_t.history, h_j, rtol=1e-10, equal_nan=True)
    x_j = np.asarray(r_j.x)
    np.testing.assert_allclose(to_np(r_t.x), x_j, rtol=1e-10,
                               atol=1e-10 * np.abs(x_j).max())
    # the final residual is recomputed, b - A x cancels to roundoff: held
    # to 1e-8 of the first residual of the history, as GMRES's
    np.testing.assert_allclose(r_t.residual_norm, float(r_j.residual_norm),
                               rtol=1e-8, atol=1e-8 * h_j[0])


def test_bicgstab_batched_lockstep(problem):
    """Four sources in lockstep through `solve_multi_rhs` (the sweep applied
    through `apply_multi`), with a zero member and a maxiter cap that stops
    one member early: each member's count, flags and history are its single
    solve's, x within 1e-10."""
    _, tprob, P_t, _ = problem
    A = tprob.A
    Bm = torch.from_numpy(random_grid(11, (4, N * N)))
    Bm[2] = 0
    mv = lambda V: torch.stack([ht.stencil_matvec_flat(A, v) for v in V])
    kw = dict(rtol=1e-9, maxiter=30)
    res = tbatched.solve_multi_rhs(mv, Bm, M=P_t, method="bicgstab",
                                   device="cpu", **kw)
    singles = [ht.bicgstab(lambda v: ht.stencil_matvec_flat(A, v), b, M=P_t,
                           device="cpu", **kw) for b in Bm]
    assert res.iterations[2] == 0 and res.converged.all()
    assert len(set(res.iterations.tolist())) > 1
    for p, one in enumerate(singles):
        assert res.iterations[p] == one.iterations
        assert res.converged[p] == one.converged
        np.testing.assert_allclose(res.history[p], one.history, rtol=1e-10,
                                   equal_nan=True)
        np.testing.assert_allclose(to_np(res.x[p]), to_np(one.x),
                                   rtol=1e-10,
                                   atol=1e-10 * np.abs(to_np(one.x)).max())
    capped = tbatched.solve_multi_rhs(mv, Bm, M=P_t, method="bicgstab",
                                      device="cpu", rtol=1e-9, maxiter=2)
    assert capped.iterations.tolist() == [2, 2, 0, 2]
    assert not capped.converged[0]
    problems = tbatched.solve_multi_problem(
        [A, A], lambda A_, v: ht.stencil_matvec_flat(A_, v), Bm[:2],
        precond_data=[P_t, P_t], apply_precond=lambda P, v: P(v),
        method="bicgstab", device="cpu", **kw)
    np.testing.assert_array_equal(problems.iterations, res.iterations[:2])


@pytest.mark.parametrize("stencil", ["5pt", "9pt"])
def test_run_solver_bicgstab_matches_jax(stencil):
    """`run_solver(method="bicgstab")` in both packages on the CPU: the
    same count, u within 1e-8 of its largest entry."""
    args = (31, 6, 2.0, 20.0)
    kw = dict(method="bicgstab", stencil=stencil)
    r_j = jdriver.run_solver(*args, **kw)
    r_t = tdriver.run_solver(*args, device="cpu", **kw)
    assert r_t.converged and r_j.converged
    assert r_t.iterations == r_j.iterations
    assert r_t.config["method"] == "bicgstab"
    np.testing.assert_allclose(r_t.u, r_j.u, rtol=1e-8,
                               atol=1e-8 * np.abs(r_j.u).max())
    assert r_t.true_residual < 1e-3


def test_bicgstab_refuses_ir_df32():
    """The refinement path is GMRES only, as in the JAX package."""
    for stencil in ("5pt", "9pt"):
        with pytest.raises(ValueError, match="requires method='gmres'"):
            tdriver.run_solver(15, 4, 1.0, 20.0, method="bicgstab",
                               precision="ir-df32", stencil=stencil,
                               device="cpu")
