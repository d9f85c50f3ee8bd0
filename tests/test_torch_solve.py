"""CPU parity of the port's setup, apply, GMRES and whole `run_solver`
slice against the JAX package, in complex128."""
import dataclasses
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu import driver as jdriver
from helmholtz_tpu.ops.spmv import stencil_matvec_flat as j_matvec_flat
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch.ops.kernels.sweep import g_ld
from helmholtz_tpu_torch.precond import sweeping as tsweep

from torch_parity import (both_problems, precond_to_torch,  # noqa: F401
                          random_grid, single_thread, stencil_to_torch,
                          to_np)

REPO = pathlib.Path(__file__).resolve().parents[1]
N, B, WAVE, CONST = 31, 6, 2.0, 20.0


@pytest.fixture(scope="module")
def problem():
    return both_problems(N, B, WAVE, CONST)


def _planes(P_t):
    return to_np(P_t.G_re)[:, :, :N] + 1j * to_np(P_t.G_im)[:, :, :N]


# -- (d) setup ----------------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 2, 5])
def test_setup_matches_jax(problem, stride):
    """G and TF against the JAX setup, 1e-9 of the largest entry (two LAPACK
    inverses of the same matrices, chained b times).  With M = 25, stride 2
    has a duplicated endpoint sample and stride 5 a short last segment;
    both layouts are held."""
    _, jprob, jhm, tprob, thm = problem
    P_j = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=False,
                                      factor_stride=stride)
    P_t = tsweep.setup_preconditioner(tprob.A, thm, B, factor_stride=stride,
                                      device="cpu")
    assert P_t.G_re.shape == (N - B, N, g_ld(N))
    assert P_t.G_re.dtype == torch.float64
    G_ref = P_j.G.to_np()
    np.testing.assert_allclose(_planes(P_t), G_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(G_ref).max())
    # the pad columns are exactly zero
    assert not to_np(P_t.G_re)[:, :, N:].any()
    assert not to_np(P_t.G_im)[:, :, N:].any()
    TF_ref = P_j.TF.to_np()
    np.testing.assert_allclose(to_np(P_t.TF), TF_ref, rtol=1e-9,
                               atol=1e-9 * np.abs(TF_ref).max())
    for name in ("hf_cs", "hf_cn", "a_cs", "a_cn"):
        np.testing.assert_allclose(to_np(getattr(P_t, name)),
                                   getattr(P_j, name).to_np(), rtol=1e-12,
                                   atol=1e-9)


def test_setup_chunking_and_storage_type(problem):
    """A small chunk (several batched inverses, ragged last one) gives the
    same stack as one batch, and bf16 storage is the rounded float stack."""
    _, _, _, tprob, thm = problem
    one = tsweep.setup_preconditioner(tprob.A, thm, B, device="cpu")
    small = tsweep.setup_preconditioner(tprob.A, thm, B, setup_chunk=4,
                                        device="cpu")
    np.testing.assert_allclose(_planes(small), _planes(one), rtol=1e-12,
                               atol=1e-12 * np.abs(_planes(one)).max())
    assert tsweep._clamped_chunk(128, 1023) == 128
    assert tsweep._clamped_chunk(tsweep.DEFAULT_SETUP_CHUNK, 1023) == \
        tsweep.SETUP_WORKSPACE_WORDS // 1023 ** 2 == 152
    assert tsweep._clamped_chunk(128, 4095) == 16
    assert tsweep._clamped_chunk(2, 31) == 4
    low = tsweep.setup_preconditioner(tprob.A, thm, B, factor_stride=3,
                                      g_dtype=torch.bfloat16, device="cpu")
    ref = tsweep.setup_preconditioner(tprob.A, thm, B, factor_stride=3,
                                      device="cpu")
    assert low.G_re.dtype == torch.bfloat16
    torch.testing.assert_close(low.G_re, ref.G_re.to(torch.bfloat16),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(tsweep.sample_positions(25, 4),
                                  jsweep.sample_positions(25, 4))


# -- (e) apply ----------------------------------------------------------------

@pytest.mark.parametrize("d2_replace", [True, False])
def test_apply_matches_jax_xla(problem, d2_replace):
    """Port setup + port apply against JAX setup + JAX `impl="xla"` apply,
    and the port's apply on the JAX-factored state, 1e-10."""
    _, jprob, jhm, tprob, thm = problem
    P_j = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=False,
                                      d2_replace=d2_replace)
    P_t = tsweep.setup_preconditioner(tprob.A, thm, B, d2_replace=d2_replace,
                                      device="cpu")
    f = random_grid(3, (N, N))
    ref = np.asarray(jsweep.apply_preconditioner(P_j, jnp.asarray(f),
                                                 impl="xla"))
    tol = dict(rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    f_t = torch.from_numpy(f)
    keep = f_t.clone()
    np.testing.assert_allclose(to_np(tsweep.apply_preconditioner(P_t, f_t)),
                               ref, **tol)
    assert torch.equal(f_t, keep)            # the argument is left untouched
    np.testing.assert_allclose(
        to_np(tsweep.apply_preconditioner(precond_to_torch(P_j, N), f_t)),
        ref, **tol)
    np.testing.assert_allclose(to_np(P_t(f_t.reshape(-1))), ref.reshape(-1),
                               **tol)


def test_apply_accepts_lane_padded_jax_state(problem):
    """Both JAX layouts of G convert to the same port state."""
    _, jprob, jhm, _, _ = problem
    P_a = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=False)
    P_b = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=True)
    a, b = precond_to_torch(P_a, N), precond_to_torch(P_b, N)
    assert torch.equal(a.G_re, b.G_re) and torch.equal(a.G_im, b.G_im)


# -- (f) GMRES ----------------------------------------------------------------

def _both_gmres(jprob, M_j, M_t, **kw):
    A_t = stencil_to_torch(jprob.A)
    b = to_np(jprob.f_vec)
    r_j = hj.gmres(lambda v: j_matvec_flat(jprob.A, v), jnp.asarray(b),
                   M=M_j, **kw)
    r_t = ht.gmres(lambda v: ht.stencil_matvec_flat(A_t, v),
                   torch.from_numpy(b.copy()), M=M_t, device="cpu", **kw)
    return r_j, r_t


def _assert_same_solve(r_j, r_t, x_rtol):
    assert r_t.iterations == int(r_j.iterations)
    assert r_t.converged == bool(r_j.converged)
    assert r_t.breakdown == bool(r_j.breakdown)
    h_j = np.asarray(r_j.history)
    assert r_t.history.shape == h_j.shape
    np.testing.assert_array_equal(np.isnan(r_t.history), np.isnan(h_j))
    np.testing.assert_allclose(r_t.history, h_j, rtol=1e-8, equal_nan=True)
    # the final residual is recomputed, b - A x cancels to roundoff: held
    # to 1e-8 of the first residual of the history
    np.testing.assert_allclose(r_t.residual_norm, float(r_j.residual_norm),
                               rtol=1e-8, atol=1e-8 * h_j[0])
    x_j = np.asarray(r_j.x)
    np.testing.assert_allclose(to_np(r_t.x), x_j, rtol=x_rtol,
                               atol=x_rtol * np.abs(x_j).max())


def test_gmres_with_preconditioner_matches_jax(problem):
    """The port's GMRES on the JAX-assembled operator with the JAX-factored
    preconditioner: identical iterations and flags, history to 1e-8."""
    _, jprob, jhm, _, _ = problem
    P_j = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=False)
    P_t = precond_to_torch(P_j, N)
    r_j, r_t = _both_gmres(jprob, P_j, P_t, restart=20, rtol=1e-8,
                           maxiter=40)
    assert r_t.converged and 2 <= r_t.iterations <= 10
    _assert_same_solve(r_j, r_t, 1e-8)


def test_gmres_without_preconditioner_matches_jax(problem):
    """Unpreconditioned GMRES(10) over several restart cycles, cut by
    maxiter before it converges: the restart, history and stopping logic."""
    _, jprob, _, _, _ = problem
    r_j, r_t = _both_gmres(jprob, None, None, restart=10, rtol=1e-6,
                           maxiter=35)
    assert not r_t.converged and r_t.iterations == 35
    assert r_t.history.shape == (40,)
    _assert_same_solve(r_j, r_t, 1e-7)


def test_gmres_edge_cases():
    """Zero right-hand side, an exact one-step solve (happy breakdown), a
    warm start and `iter_cap`."""
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.uniform(1.0, 2.0, 12) + 0j)
    mv = lambda v: d * v
    zero = ht.gmres(mv, torch.zeros(12, dtype=torch.complex128),
                    device="cpu")
    assert zero.converged and zero.iterations == 0
    b = torch.from_numpy(random_grid(6, (12,)))
    ident = ht.gmres(lambda v: v, b, rtol=1e-12, device="cpu")
    assert ident.converged and ident.iterations == 1
    np.testing.assert_allclose(to_np(ident.x), to_np(b), rtol=1e-12)
    full = ht.gmres(mv, b, rtol=1e-10, restart=12, device="cpu")
    assert full.converged
    np.testing.assert_allclose(to_np(full.x), to_np(b / d), rtol=1e-8)
    warm = ht.gmres(mv, b, x0=full.x, rtol=1e-8, device="cpu")
    assert warm.converged and warm.iterations == 0
    capped = ht.gmres(mv, b, rtol=1e-14, restart=4, maxiter=40, iter_cap=6,
                      device="cpu")
    assert capped.iterations == 6 and not capped.converged
    c64 = ht.gmres(lambda v: d.to(torch.complex64) * v,
                   b.to(torch.complex64), rtol=1e-4, restart=12,
                   device="cpu")
    assert c64.converged and c64.x.dtype == torch.complex64
    assert c64.history.dtype == np.float32


# -- (g) the slice as a whole -------------------------------------------------

@pytest.mark.parametrize("prob_name", ["c1_f1", "c2_f1"])
def test_run_solver_matches_jax(prob_name):
    """`run_solver(63, 12, 4.0, 61.0)` in both packages on the CPU: equal
    iteration counts, u to 1e-8 of its largest entry.  c2_f1 takes the
    shared-G path (one factored subgrid)."""
    r_j = jdriver.run_solver(63, 12, 4.0, 61.0, problem=prob_name)
    r_t = tdriver.run_solver(63, 12, 4.0, 61.0, problem=prob_name,
                             device="cpu")
    assert r_t.iterations == r_j.iterations
    assert r_t.converged and r_j.converged
    assert isinstance(r_t.iterations, int)
    assert isinstance(r_t.converged, bool)
    assert isinstance(r_t.history, np.ndarray)
    np.testing.assert_allclose(r_t.history, r_j.history, rtol=1e-7)
    np.testing.assert_allclose(r_t.u, r_j.u, rtol=1e-8,
                               atol=1e-8 * np.abs(r_j.u).max())
    np.testing.assert_allclose(r_t.true_residual, r_j.true_residual,
                               rtol=1e-6)
    assert r_t.config["dedup_hm"] == (prob_name == "c2_f1")
    assert r_t.config["factor_stride"] == 1
    assert r_t.config["dtype"] == "complex128"
    assert set(r_t.metrics()) >= {"iterations", "init_time_s",
                                  "solve_time_s", "n"}


def test_run_solver_oracle_n127():
    """The complex128 scipy oracle needs 2 iterations at n=127, rtol 1e-3
    (ORACLE.json); so does the port."""
    rows = [json.loads(l) for l in
            (REPO / "ORACLE.json").read_text().splitlines() if l.strip()]
    oracle = next(r for r in rows
                  if r.get("metric") == "oracle_iters_n127_rtol0.001")
    r = tdriver.run_solver(oracle["n"], oracle["b"], oracle["wave_num"],
                           oracle["const"], rtol=oracle["rtol"],
                           device="cpu")
    assert r.converged and r.iterations == oracle["iters"] == 2
    assert r.true_residual < 1e-3


def test_run_solver_options():
    """Strided bf16 setup, compressed G, the as-shipped variants,
    refinement, no preconditioner; and the options of later slices raise by
    name."""
    base = tdriver.run_solver(N, B, WAVE, CONST, device="cpu")
    strided = tdriver.run_solver(N, B, WAVE, CONST, factor_stride=3,
                                 g_dtype="bf16", device="cpu")
    assert strided.converged
    assert strided.iterations <= base.iterations + 1
    refined = tdriver.run_solver(N, B, WAVE, CONST, g_dtype="bf16",
                                 precond_refine=1, device="cpu")
    assert refined.converged and refined.iterations <= base.iterations
    shipped = tdriver.run_solver(N, B, WAVE, CONST, fidelity="as-shipped",
                                 hf_full_coupling=False, d2_replace=False,
                                 maxiter=40, device="cpu")
    assert shipped.iterations > base.iterations
    plain = tdriver.run_solver(15, 4, 1.0, 20.0, precond="none", maxiter=400,
                               restart=40, rtol=1e-6, device="cpu")
    assert plain.converged and plain.true_residual < 1e-5
    packed = tdriver.run_solver(N, B, WAVE, CONST, factor_stride=4,
                                g_compress=True, device="cpu")
    expanded = tdriver.run_solver(N, B, WAVE, CONST, factor_stride=4,
                                  device="cpu")
    assert packed.converged and packed.config["g_compress"]
    assert packed.iterations == expanded.iterations
    for kw, name in ((dict(method="bicgstab"), "solver-extras"),
                     (dict(stencil="9pt"), "5-point"),
                     (dict(precond="exact"), "moving_pml")):
        with pytest.raises(NotImplementedError, match=name):
            tdriver.run_solver(15, 4, 1.0, 20.0, device="cpu", **kw)
    with pytest.raises(ValueError, match="precision"):
        tdriver.run_solver(15, 4, 1.0, 20.0, device="cpu", precision="f64")
    assert tdriver.auto_factor_stride(1023, "c1_f1", "cuda") == 7
    assert tdriver.auto_factor_stride(4095, "c1_f1", "cuda") == 8
    assert tdriver.auto_factor_stride(1023, "c1_f1", "cpu") == 1
    assert tdriver.auto_factor_stride(1023, "rough", "cuda") == 1
    assert tdriver.default_complex_dtype("cuda") == torch.complex64
    assert tdriver.default_complex_dtype("cpu") == torch.complex128
