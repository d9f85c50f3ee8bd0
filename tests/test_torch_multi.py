"""CPU parity of the port's batched slice against the JAX package, in
complex128: the sweep with R > 1 right-hand sides and with sample-compressed
G (lerp), the batched apply, the lockstep batched GMRES, `run_multisolve`
and its omega-amortized sweep.

The CUDA kernel runs only on the card, where the smoke script at the
repository root holds it against the plain versions tested here.
"""
import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu import driver as jdriver
from helmholtz_tpu.core.complexlib import CArray
from helmholtz_tpu.ops.pallas.sweep import pallas_sweep
from helmholtz_tpu.ops.spmv import stencil_matvec_flat as j_matvec_flat
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu.solve.batched import solve_multi_rhs as j_solve_multi_rhs
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch.ops import spmv as tspmv
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.solve import batched as tbatched

from torch_parity import (both_problems, precond_to_torch,  # noqa: F401
                          random_grid, single_thread, stencil_to_torch,
                          to_np)

N, B, WAVE, CONST = 33, 6, 2.0, 20.0
M_ROWS = N - B


@pytest.fixture(scope="module")
def problem():
    return both_problems(N, B, WAVE, CONST)


@pytest.fixture(scope="module")
def factored(problem):
    """JAX-factored preconditioners in the Pallas layout (lane-padded G),
    dense and sample-compressed at strides 3 and 4, each with its
    conversion to the port."""
    _, jprob, jhm, _, _ = problem
    out = {}
    for stride in (1, 3, 4):
        P_j = jsweep.setup_preconditioner(
            jprob.A, jhm, B, pad_lanes=True, factor_stride=stride,
            g_compress=stride > 1)
        out[stride] = (P_j, precond_to_torch(P_j, N))
    return out


def _sweep_inputs(mode, R):
    S = M_ROWS - 1 if mode == "fwd" else M_ROWS
    shape = (S, N) if R is None else (S, R, N)
    u = random_grid(10, shape)
    c = random_grid(11, (S, N))
    if mode != "fwd":
        c[-1] = 0
    carry0 = random_grid(12, shape[1:])
    return u, c, carry0


def _pallas(P_j, u, c, carry0, mode):
    return pallas_sweep(P_j.G, CArray.of(jnp.asarray(u)),
                        CArray.of(jnp.asarray(c)),
                        CArray.of(jnp.asarray(carry0)), mode=mode,
                        interpret=True, g_lo=P_j.g_lo, g_w=P_j.g_w).to_np()


def _port(P_t, u, c, carry0, mode):
    return to_np(k2.sweep(P_t.G_re, P_t.G_im, torch.from_numpy(u),
                          torch.from_numpy(c), torch.from_numpy(carry0),
                          mode=mode, g_lo=P_t.g_lo, g_w=P_t.g_w))


# -- K2 with R > 1 and with lerp ----------------------------------------------

@pytest.mark.parametrize("mode", ["fwd", "bwd", "bwd_sub"])
def test_plain_sweep_batched_matches_pallas_interpret(factored, mode):
    """R = 3 right-hand sides on one stream of the dense stack against the
    Pallas kernel in interpret mode; float64 G, 1e-10 of the largest entry
    (the same products summed in another order)."""
    P_j, P_t = factored[1]
    u, c, carry0 = _sweep_inputs(mode, 3)
    ref = _pallas(P_j, u, c, carry0, mode)
    got = _port(P_t, u, c, carry0, mode)
    assert got.shape == ref.shape == u.shape
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())
    # a member of the batch is its own single sweep
    one = _port(P_t, u[:, 1], c, carry0[1], mode)
    np.testing.assert_allclose(got[:, 1], one, rtol=1e-12,
                               atol=1e-12 * np.abs(one).max())


@pytest.mark.parametrize("R", [None, 3], ids=["R1", "R3"])
@pytest.mark.parametrize("stride", [3, 4])
def test_plain_sweep_lerp_matches_pallas_interpret(factored, stride, R):
    """Sample-compressed G: the weights go on the two panels' products, as
    the Pallas kernel applies them; all three modes (R = 3: fwd and bwd,
    which differ from bwd_sub only in the epilogue), 1e-10.  Stride 3 has
    weights that float32 does not hold exactly, stride 4 exact ones; with
    M = 27 stride 3 has a short last segment."""
    P_j, P_t = factored[stride]
    assert P_t.g_stride == stride and P_t.g_w.dtype == torch.float32
    assert P_t.G_re.shape[0] == (M_ROWS - 1) // stride + 2
    for mode in k2.MODES if R is None else ("fwd", "bwd"):
        u, c, carry0 = _sweep_inputs(mode, R)
        ref = _pallas(P_j, u, c, carry0, mode)
        got = _port(P_t, u, c, carry0, mode)
        np.testing.assert_allclose(got, ref, rtol=1e-10,
                                   atol=1e-10 * np.abs(ref).max(),
                                   err_msg=mode)


def test_lerp_tables_match_jax_and_allow_zero_weights(factored):
    """`compress_tables` and `band_sample_window` equal the reference's
    (float32 weights, int32 indices); any index up to Ms - 2 and zero
    weights are taken, and give exactly what the formula says."""
    for M, R in ((27, 3), (27, 4), (25, 2), (1011, 7)):
        g_w, g_lo = tsweep.compress_tables(M, R)
        jw, jlo = jsweep.compress_tables(M, R)
        assert g_w.dtype == np.float32 and g_lo.dtype == np.int32
        np.testing.assert_array_equal(g_w, np.asarray(jw))
        np.testing.assert_array_equal(g_lo, np.asarray(jlo))
        assert tsweep.band_sample_window(M, R, 3, M - 2) == \
            jsweep.band_sample_window(M, R, 3, M - 2)
    _, P_t = factored[4]
    Ms = P_t.G_re.shape[0]
    u, c, carry0 = (torch.from_numpy(a) for a in _sweep_inputs("bwd", None))
    rng = np.random.default_rng(3)
    g_lo = torch.from_numpy(rng.integers(0, Ms - 1, M_ROWS).astype(np.int32))
    g_lo[0], g_lo[1] = Ms - 2, 0
    g_w = torch.from_numpy(rng.uniform(0, 1, (M_ROWS, 2)).astype(np.float32))
    g_w[5] = 0.0
    got = k2.sweep(P_t.G_re, P_t.G_im, u, c, carry0, mode="bwd", g_lo=g_lo,
                   g_w=g_w)
    assert not got[5].any()                 # zero weights: a zero panel
    # the same operator written out as a dense stack
    w = g_w.double()[:, :, None, None]
    lo = g_lo.long()
    G_re = w[:, 0] * P_t.G_re[lo] + w[:, 1] * P_t.G_re[lo + 1]
    G_im = w[:, 0] * P_t.G_im[lo] + w[:, 1] * P_t.G_im[lo + 1]
    ref = k2.plain_sweep(G_re, G_im, u, c, carry0, mode="bwd")
    torch.testing.assert_close(got, ref, rtol=1e-12, atol=1e-12)


def test_sweep_wrapper_checks_and_counters(factored):
    """What the wrapper refuses for the new modes, and that nothing is
    counted as a launch on the CPU."""
    _, P_t = factored[4]
    u, c, carry0 = (torch.from_numpy(a) for a in _sweep_inputs("bwd", 3))
    args = (P_t.G_re, P_t.G_im, u, c, carry0)
    with pytest.raises(ValueError, match="both g_lo and g_w"):
        k2.sweep(*args, mode="bwd", g_lo=P_t.g_lo)
    with pytest.raises(ValueError, match="int32"):
        k2.sweep(*args, mode="bwd", g_lo=P_t.g_lo.long(), g_w=P_t.g_w)
    with pytest.raises(ValueError, match="float32"):
        k2.sweep(*args, mode="bwd", g_lo=P_t.g_lo, g_w=P_t.g_w.double())
    with pytest.raises(ValueError, match="steps"):
        k2.sweep(*args, mode="bwd", g_lo=P_t.g_lo[:-1], g_w=P_t.g_w[:-1])
    with pytest.raises(ValueError, match="carry0"):
        k2.sweep(P_t.G_re, P_t.G_im, u, c, carry0[:2], mode="bwd",
                 g_lo=P_t.g_lo, g_w=P_t.g_w)
    with pytest.raises(ValueError, match="g_lo runs"):
        dataclasses.replace(P_t, g_lo=P_t.g_lo + 1)
    with pytest.raises(ValueError, match="lerp tables"):
        dataclasses.replace(P_t, g_stride=0)
    # the kernel's own limits: 4 right-hand sides of row pitch 7272 floats
    # pass 227 KB of shared memory, and the wrapper raises rather than
    # splitting further
    G32 = torch.empty((0, 7265, k2.g_ld(7265)))
    wide = torch.zeros((2, 4, 7265), dtype=torch.complex64)
    c_wide = torch.zeros((2, 7265), dtype=torch.complex64)
    with pytest.raises(ValueError, match="shared memory"):
        k2.check_kernel_args(G32, G32, wide, c_wide, wide[0])
    k2.check_kernel_args(G32, G32, wide[:, :3].contiguous(), c_wide,
                         wide[0, :3])
    with pytest.raises(ValueError, match="g_lo is on|contiguous"):
        k2.check_kernel_args(
            P_t.G_re.float(), P_t.G_im.float(), u.to(torch.complex64),
            c.to(torch.complex64), carry0.to(torch.complex64),
            P_t.g_lo[::2], P_t.g_w[::2])
    k2.reset_counts()
    k2.sweep(*args, mode="bwd", g_lo=P_t.g_lo, g_w=P_t.g_w)
    assert k2.launches == 0 and k2.launches_lerp == 0
    assert not k2.launches_by_variant and not any(
        k2.launches_by_width.values())
    k2._count("bwd", 4, True)
    k2._count("fwd", 2, False)
    assert (k2.launches, k2.launches_lerp) == (2, 1)
    assert k2.launches_by_width == {1: 0, 2: 1, 3: 0, 4: 1}
    assert k2.launches_by_variant == {("bwd", 4, True): 1,
                                      ("fwd", 2, False): 1}
    k2.reset_counts()
    assert k2.launches == 0 and not k2.launches_by_variant


# -- the batched apply ---------------------------------------------------------

@pytest.mark.parametrize("stride", [1, 3], ids=["dense", "compressed"])
def test_apply_multi_matches_jax_pallas(factored, stride):
    """`apply_preconditioner_multi` on the converted state against JAX's
    with `impl="pallas"` (interpret mode), and against stacked single
    applies; 1e-10."""
    P_j, P_t = factored[stride]
    F = random_grid(20, (3, N, N))
    ref = np.asarray(jsweep.apply_preconditioner_multi(
        P_j, jnp.asarray(F), impl="pallas"))
    F_t = torch.from_numpy(F)
    keep = F_t.clone()
    got = tsweep.apply_preconditioner_multi(P_t, F_t)
    assert torch.equal(F_t, keep)
    tol = dict(rtol=1e-10, atol=1e-10 * np.abs(ref).max())
    np.testing.assert_allclose(to_np(got), ref, **tol)
    singles = torch.stack([tsweep.apply_preconditioner(P_t, f) for f in F_t])
    np.testing.assert_allclose(to_np(got), to_np(singles), rtol=1e-12,
                               atol=1e-12 * np.abs(ref).max())
    flat = P_t.apply_multi(F_t.reshape(3, -1))
    assert torch.equal(flat.reshape(3, N, N), got)


@pytest.mark.parametrize("d2_replace", [True, False], ids=["bwd", "bwd_sub"])
def test_compressed_equals_expanded_at_stride_4(problem, d2_replace):
    """The port's own compressed setup against its expanded strided setup:
    the same interpolated operator, 1e-12, because stride 4 weights are
    exact in float32 (at stride 3 or 7 they are not, and the two applies
    differ by the weights' float32 rounding, about 1.5e-7 of the result)."""
    _, _, _, tprob, thm = problem
    kw = dict(factor_stride=4, d2_replace=d2_replace, device="cpu")
    P_exp = tsweep.setup_preconditioner(tprob.A, thm, B, **kw)
    P_cmp = tsweep.setup_preconditioner(tprob.A, thm, B, g_compress=True,
                                        **kw)
    assert P_exp.g_stride == 0 and P_exp.g_lo is None
    assert P_cmp.g_stride == 4 and P_cmp.G_re.shape == (8, N, k2.g_ld(N))
    assert P_cmp.g_w.shape == (M_ROWS, 2) and P_cmp.g_lo.shape == (M_ROWS,)
    f = torch.from_numpy(random_grid(21, (N, N)))
    a = tsweep.apply_preconditioner(P_exp, f)
    b = tsweep.apply_preconditioner(P_cmp, f)
    torch.testing.assert_close(b, a, rtol=1e-12, atol=1e-12)
    F = torch.stack([f, 2.0 * f, f.conj()])
    torch.testing.assert_close(tsweep.apply_preconditioner_multi(P_cmp, F),
                               tsweep.apply_preconditioner_multi(P_exp, F),
                               rtol=1e-12, atol=1e-12)
    # no stride to speak of: g_compress falls back to the dense stack
    P_one = tsweep.setup_preconditioner(tprob.A, thm, B, g_compress=True,
                                        factor_stride=1, device="cpu")
    assert P_one.g_stride == 0 and P_one.G_re.shape[0] == M_ROWS


def test_compressed_setup_matches_jax(problem, factored):
    """The port's compressed setup against JAX's: samples to 1e-9 (as the
    dense setup), identical tables; and JAX's `impl="xla"` apply of it."""
    _, jprob, _, tprob, thm = problem
    P_j, P_conv = factored[3]
    P_t = tsweep.setup_preconditioner(tprob.A, thm, B, factor_stride=3,
                                      g_compress=True, device="cpu")
    assert torch.equal(P_t.g_lo, P_conv.g_lo)
    assert torch.equal(P_t.g_w, P_conv.g_w)
    for got, ref in ((P_t.G_re, P_conv.G_re), (P_t.G_im, P_conv.G_im)):
        torch.testing.assert_close(got, ref, rtol=1e-9,
                                   atol=1e-9 * ref.abs().max().item())
    f = random_grid(22, (N, N))
    ref = np.asarray(jsweep.apply_preconditioner(P_j, jnp.asarray(f),
                                                 impl="xla"))
    got = to_np(tsweep.apply_preconditioner(P_t, torch.from_numpy(f)))
    np.testing.assert_allclose(got, ref, rtol=1e-9,
                               atol=1e-9 * np.abs(ref).max())


# -- batched GMRES --------------------------------------------------------------

def _rhs_batch(jprob):
    """Four right-hand sides that need different iteration counts: the
    problem's own smooth forcing and random ones."""
    rows = [to_np(jprob.f_vec), random_grid(30, (N * N,)),
            1e3 * random_grid(31, (N * N,)),
            to_np(jprob.f_vec) + 1e-3 * random_grid(32, (N * N,))]
    return np.stack(rows)


def _assert_member_equals_single(res, p, single, x_rtol):
    assert res.iterations[p] == single.iterations
    assert res.converged[p] == single.converged
    assert res.breakdown[p] == single.breakdown
    # late entries are small differences of nearly equal numbers
    np.testing.assert_allclose(res.history[p], single.history, rtol=1e-6,
                               equal_nan=True)
    np.testing.assert_allclose(res.residual_norm[p], single.residual_norm,
                               rtol=1e-6, atol=1e-9 * single.history[0])
    x = to_np(single.x)
    np.testing.assert_allclose(to_np(res.x[p]), x, rtol=x_rtol,
                               atol=x_rtol * np.abs(x).max())


@pytest.mark.parametrize("kw", [
    dict(restart=20, rtol=1e-8, maxiter=40),
    dict(restart=3, rtol=1e-8, maxiter=40),      # several cycles, per member
    dict(restart=4, rtol=1e-10, maxiter=6),      # cut by maxiter mid-cycle
], ids=["one-cycle", "restarts", "maxiter"])
def test_batched_gmres_equals_stacked_single_solves(problem, factored, kw):
    """The lockstep batch gives every member its single solve: exact
    iteration counts and flags, history to 1e-6, x to 1e-10; and a member's
    result does not depend on who else is in the batch."""
    _, jprob, _, _, _ = problem
    _, P_t = factored[1]
    A_t = stencil_to_torch(jprob.A)
    Bm = torch.from_numpy(_rhs_batch(jprob))
    mv = lambda V: tspmv.stencil_matvec_flat(A_t, V)
    res = tbatched.solve_multi_rhs(mv, Bm, M=P_t, device="cpu", **kw)
    singles = [ht.gmres(mv, b, M=P_t, device="cpu", **kw) for b in Bm]
    assert len(set(s.iterations for s in singles)) > 1 or kw["maxiter"] == 6
    assert res.history.shape == (4,) + singles[0].history.shape
    for p, single in enumerate(singles):
        _assert_member_equals_single(res, p, single, 1e-10)
    pair = tbatched.solve_multi_rhs(mv, Bm[[2, 0]], M=P_t, device="cpu",
                                    **kw)
    np.testing.assert_array_equal(pair.iterations, res.iterations[[2, 0]])
    np.testing.assert_allclose(to_np(pair.x), to_np(res.x[[2, 0]]),
                               rtol=1e-10, atol=1e-12)


def test_batched_gmres_edge_cases():
    """A zero member, a member that is solved in one step, caps per member,
    a warm start, and the options of other slices."""
    rng = np.random.default_rng(5)
    d = torch.from_numpy(rng.uniform(1.0, 2.0, 12) + 0j)
    mv = lambda V: d * V
    Bm = torch.from_numpy(random_grid(6, (3, 12)))
    Bm[1] = 0
    res = tbatched.gmres_batched(mv, Bm, rtol=1e-10, restart=12,
                                 device="cpu")
    assert res.converged.all() and res.iterations[1] == 0
    np.testing.assert_allclose(to_np(res.x), to_np(Bm / d), rtol=1e-8)
    ident = tbatched.gmres_batched(lambda V: V, Bm, rtol=1e-12, device="cpu")
    assert ident.iterations.tolist() == [1, 0, 1] and ident.converged.all()
    assert torch.equal(Bm[1], torch.zeros(12, dtype=torch.complex128))
    capped = tbatched.gmres_batched(mv, Bm, rtol=1e-14, restart=4,
                                    maxiter=40, iter_cap=[6, 6, 2],
                                    device="cpu")
    assert capped.iterations.tolist() == [6, 0, 2]
    assert capped.converged.tolist() == [False, True, False]
    warm = tbatched.gmres_batched(mv, Bm, x0=res.x, rtol=1e-8, device="cpu")
    assert warm.iterations.tolist() == [0, 0, 0] and warm.converged.all()
    for fn in (lambda: tbatched.solve_multi_rhs(mv, Bm, method="bicgstab"),
               lambda: tbatched.solve_multi_problem([d], None, Bm[:1],
                                                    method="bicgstab")):
        with pytest.raises(NotImplementedError, match="item 13"):
            fn()
    with pytest.raises(ValueError, match="method"):
        tbatched.solve_multi_rhs(mv, Bm, method="cg")


def test_solve_multi_rhs_matches_jax(problem, factored):
    """The port's batched solve on the JAX-assembled operator and the
    JAX-factored preconditioner against JAX's `solve_multi_rhs`: identical
    per-source iteration counts and flags, history to 1e-8, x to 1e-8."""
    _, jprob, _, _, _ = problem
    P_j, P_t = factored[1]
    A_t = stencil_to_torch(jprob.A)
    Bm = _rhs_batch(jprob)
    kw = dict(restart=20, rtol=1e-8, maxiter=40)
    r_j = j_solve_multi_rhs(lambda v: j_matvec_flat(jprob.A, v),
                            jnp.asarray(Bm), M=P_j, **kw)
    r_t = tbatched.solve_multi_rhs(
        lambda V: tspmv.stencil_matvec_flat(A_t, V), torch.from_numpy(Bm),
        M=P_t, device="cpu", **kw)
    np.testing.assert_array_equal(r_t.iterations, np.asarray(r_j.iterations))
    np.testing.assert_array_equal(r_t.converged, np.asarray(r_j.converged))
    np.testing.assert_array_equal(r_t.breakdown, np.asarray(r_j.breakdown))
    assert r_t.converged.all() and len(set(r_t.iterations.tolist())) > 1
    h_j = np.asarray(r_j.history)
    assert r_t.history.shape == h_j.shape
    np.testing.assert_allclose(r_t.history, h_j, rtol=1e-8, equal_nan=True)
    x_j = np.asarray(r_j.x)
    np.testing.assert_allclose(to_np(r_t.x), x_j, rtol=1e-8,
                               atol=1e-8 * np.abs(x_j).max())


def test_solve_multi_problem_equals_single_solves(problem, factored):
    """A batch of independent systems (two frequencies' operators and
    factor stacks) gives each its own single solve."""
    _, _, _, tprob, _ = problem
    _, _, _, tprob2, thm2 = both_problems(N, B, 2.5, CONST)
    P1 = factored[1][1]
    P2 = tsweep.setup_preconditioner(tprob2.A, thm2, B, device="cpu")
    Bm = torch.stack([tprob.f_vec, tprob2.f_vec])
    kw = dict(rtol=1e-6, maxiter=40, device="cpu")
    res = tbatched.solve_multi_problem(
        [tprob.A, tprob2.A], tspmv.stencil_matvec_flat, Bm,
        precond_data=[P1, P2], apply_precond=lambda P, v: P(v), **kw)
    for p, (A, P) in enumerate(((tprob.A, P1), (tprob2.A, P2))):
        single = ht.gmres(lambda v: tspmv.stencil_matvec_flat(A, v), Bm[p],
                          M=P, **kw)
        assert res.iterations[p] == single.iterations and res.converged[p]
        assert torch.equal(res.x[p], single.x)
    bare = tbatched.solve_multi_problem(
        [tprob.A], tspmv.stencil_matvec_flat, Bm[:1], rtol=1e-3, maxiter=3,
        restart=3, device="cpu")
    assert bare.iterations.tolist() == [3] and not bare.converged[0]


# -- run_multisolve ------------------------------------------------------------

MS_ARGS = (31, 5, [2.0])
MS_KW = dict(consts=[20.0], n_sources=2, rtol=1e-3, maxiter=60)
AM_ARGS = (31, 5, [2.1, 2.0, 2.05])     # the direct run's grid: JAX reuses
AM_KW = dict(consts=[20.0], n_sources=2, rtol=1e-3, maxiter=60,  # its stages
             factor_stride=4, g_compress=True, freq_anchor_every=2)


@pytest.fixture(scope="module")
def multisolve_records():
    """One JAX run and one port run per configuration: the direct one of
    the JAX package's own driver test, and a three-frequency amortized
    sweep given out of order."""
    return {
        "direct": (jdriver.run_multisolve(*MS_ARGS, **MS_KW),
                   tdriver.run_multisolve(*MS_ARGS, device="cpu", **MS_KW)),
        "amortized": (jdriver.run_multisolve(*AM_ARGS, **AM_KW),
                      tdriver.run_multisolve(*AM_ARGS, device="cpu",
                                             **AM_KW)),
    }


def _assert_records_match(recs_j, recs_t):
    assert len(recs_t) == len(recs_j)
    for r_j, r_t in zip(recs_j, recs_t):
        assert set(r_t) == set(r_j)
        for key in r_j:
            if key in ("init_time_s", "solve_time_s", "compiled",
                       "true_residuals", "g_bytes_at_rest",
                       "g_traffic_gb_per_apply"):
                continue
            assert r_t[key] == r_j[key], key
        assert r_t["compiled"] is False
        # the same x to solver precision: residuals of the same size
        np.testing.assert_allclose(r_t["true_residuals"],
                                   r_j["true_residuals"], rtol=1e-5)
        assert all(isinstance(i, int) for i in r_t["iterations"])
        assert all(isinstance(c, bool) for c in r_t["converged"])


def test_run_multisolve_matches_jax(multisolve_records):
    """`run_multisolve(31, 5, [2.0], consts=[20.0], n_sources=2)`: the same
    record keys and values, iteration counts included; the at-rest bytes are
    the port's own (its planes have row pitch 32, not 31)."""
    recs_j, recs_t = multisolve_records["direct"]
    _assert_records_match(recs_j, recs_t)
    [rec] = recs_t
    assert rec["converged"] == [True, True]
    assert all(r < 5e-2 for r in rec["true_residuals"])
    assert rec["g_bytes_at_rest"] == 2 * 26 * 31 * 32 * 8
    assert rec["dtype"] == "complex128" and rec["factor_stride"] == 1
    assert "setup_mode" not in rec


def test_run_multisolve_solution_matches_jax():
    """The stages of one frequency in both packages (the direct run's
    configuration, at rtol 1e-6): sources to 1e-12, the batched solve's u to
    1e-8 of its largest entry, equal counts."""
    n, b, wn, C, alpha = 31, 5, 2.0, 20.0, 2.0
    r1s = np.linspace(0.2, 0.8, 2)
    r2s = np.full((2,), 0.125)
    as_j = lambda v: jnp.asarray(v, jnp.float64)
    F_j = jdriver._sources_stage(as_j(wn), as_j(alpha), jnp.asarray(r1s),
                                 jnp.asarray(r2s), n=n, problem="c1_f1",
                                 cdtype=jnp.complex128)
    (A_j, hm_j, _), _ = jdriver._assemble_stage(
        as_j(wn), as_j(C), as_j(alpha), n=n, b=b, problem="c1_f1",
        fidelity="corrected", cdtype=jnp.complex128)
    P_j = jdriver._factor_stage(A_j, hm_j, b=b, hf_full_coupling=True,
                                d2_replace=True, setup_chunk=128)
    r_j = jdriver._msolve_stage(A_j, P_j, F_j, as_j(1e-6), restart=20,
                                maxiter=60)
    stage = dict(n=n, problem="c1_f1", cdtype=torch.complex128, device="cpu")
    F_t = tdriver._sources_stage(wn, alpha, r1s, r2s, **stage)
    np.testing.assert_allclose(to_np(F_t), F_j.to_np(), rtol=1e-12,
                               atol=1e-14)
    A_t, hm_t, _ = tdriver._assemble_stage(wn, C, alpha, b=b,
                                           fidelity="corrected", **stage)
    P_t = tdriver._factor_stage(A_t, hm_t, b=b, hf_full_coupling=True,
                                d2_replace=True, setup_chunk=128,
                                device="cpu")
    r_t = tdriver._msolve_stage(A_t, P_t, F_t, 1e-6, restart=20, maxiter=60,
                                device="cpu")
    np.testing.assert_array_equal(r_t.iterations, np.asarray(r_j.iterations))
    assert r_t.converged.all()
    x_j = r_j.x.to_np()
    np.testing.assert_allclose(to_np(r_t.x), x_j, rtol=1e-8,
                               atol=1e-8 * np.abs(x_j).max())


def test_run_multisolve_amortized_matches_jax(multisolve_records):
    """Three frequencies given out of order, an anchor every second one:
    records come back in the caller's order, the middle frequency is
    omega-lerped, and the counts equal JAX's.  The port repeats the
    reference's float32 lerp of the anchor stacks, so the preconditioners
    agree to solver precision and no looser tolerance is needed."""
    recs_j, recs_t = multisolve_records["amortized"]
    assert [r["wave_num"] for r in recs_t] == AM_ARGS[2]
    assert [r["setup_mode"] for r in recs_t] == \
        [r["setup_mode"] for r in recs_j] == ["factor", "factor",
                                              "omega_lerp"]
    _assert_records_match(recs_j, recs_t)
    for rec in recs_t:
        assert rec["converged"] == [True, True]
        assert rec["g_bytes_at_rest"] == 2 * 8 * 31 * 32 * 8   # 8 samples


def test_omega_lerp_pair_is_float32_like_the_reference():
    """The anchor stacks are lerped in float32 and stored back at their own
    type, also in float64 runs, exactly as the reference does."""
    rng = np.random.default_rng(8)
    a, b_ = rng.standard_normal((2, 3, 5, 8))
    tau = 0.3
    ref = jdriver._omega_lerp_pair(jnp.asarray(a), jnp.asarray(a[::-1]),
                                   jnp.asarray(b_), jnp.asarray(b_[::-1]),
                                   jnp.asarray(tau))
    got = tdriver._omega_lerp_pair(
        torch.from_numpy(a), torch.from_numpy(a[::-1].copy()),
        torch.from_numpy(b_), torch.from_numpy(b_[::-1].copy()), tau)
    for g, r in zip(got, ref):
        assert g.dtype == torch.float64
        np.testing.assert_allclose(to_np(g), np.asarray(r), rtol=2e-7,
                                   atol=1e-7)
        assert torch.equal(g, g.float().double())   # float32 values
    low = tdriver._omega_lerp_pair(*(torch.from_numpy(x).bfloat16()
                                     for x in (a, a, b_, b_)), tau)
    assert low[0].dtype == torch.bfloat16


def test_run_multisolve_guards():
    """The amortized path refuses what it cannot honor, with the
    reference's key words; other slices' options raise by name."""
    run = lambda *a, **k: tdriver.run_multisolve(*a, device="cpu", **k)
    with pytest.raises(ValueError, match="g_compress"):
        run(31, 5, [2.0, 2.1], consts=[20.0], freq_anchor_every=2,
            factor_stride=1)
    with pytest.raises(ValueError, match="g_compress"):
        run(31, 5, [2.0, 2.1], consts=[20.0], freq_anchor_every=2,
            factor_stride=4)
    with pytest.raises(ValueError, match="single const"):
        run(31, 5, [2.0, 2.1], consts=[20.0, 21.0], freq_anchor_every=2,
            factor_stride=4, g_compress=True)
    with pytest.raises(ValueError, match="2 consts for 3"):
        run(31, 5, [2.0, 2.1, 2.2], consts=[20.0, 21.0])
    for kw, name in ((dict(mesh_devices=4), "distributed"),
                     (dict(stencil="9pt"), "9-point"),
                     (dict(precond="recompute"), "recompute")):
        with pytest.raises(NotImplementedError, match=name):
            run(31, 5, [2.0], **kw)
    with pytest.raises(ValueError, match="stencil"):
        run(31, 5, [2.0], stencil="7pt")
    with pytest.raises(ValueError, match="precond"):
        run(31, 5, [2.0], precond="none")
    with pytest.raises(RuntimeError, match="cuda"):
        tdriver.run_multisolve(31, 5, [2.0])      # no card here, no fallback


def test_multisolve_key_config_matches_jax():
    for kw in (dict(), dict(g_dtype="bf16", factor_stride=7, g_compress=True,
                            freq_anchor_every=4),
               dict(precision="ir-df32", precond_refine=1, fidelity="x"),
               dict(stencil="9pt", stencil_gamma=0.5, mesh_devices=4)):
        ref = jdriver.multisolve_key_config(63, 12, "c1_f1", 1e-3, 4, **kw)
        got = tdriver.multisolve_key_config(63, 12, "c1_f1", 1e-3, 4,
                                            device="cpu", **kw)
        assert got == ref and list(got) == list(ref)
    assert tdriver.multisolve_key_config(
        1023, 12, "c1_f1", 1e-3, 4)["factor_stride"] == 7
