"""CPU parity of the port's 9-point sweeping preconditioner against the JAX
package in complex128 on tiny grids: the tridiagonal Schur recursion, every
setup layout, the sweep recursion with tridiagonal coupling (the plain
version of the CUDA kernel against the Pallas kernel in interpret mode) and
the apply.  Random inputs are made with numpy from a seed and handed to both
sides; the JAX functions are called un-jitted where there is a choice.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmholtz_tpu.core.complexlib import CArray
from helmholtz_tpu.ops.pallas.sweep import pallas_sweep
from helmholtz_tpu.precond import sweeping9 as jsweep9
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.precond import sweeping9 as tsweep9

from torch_parity import (port_problems9, precond9_to_torch,  # noqa: F401
                          random_grid, to_np)

N, B, WAVE, CONST, STRIDE = 24, 4, 2.0, 30.0, 4
M = N - B


@pytest.fixture(scope="module")
def sides():
    return port_problems9(N, B, WAVE, CONST)


@pytest.fixture(scope="module")
def factored(sides):
    """Dense and sample-compressed preconditioners factored by JAX (the
    compressed one lane-padded, the Pallas layout), and their conversions."""
    _, (jA, jhm, _, _), _ = sides
    dense = jsweep9.setup_preconditioner9(jA, jhm, B, pad_lanes=True)
    packed = jsweep9.setup_preconditioner9(jA, jhm, B, pad_lanes=True,
                                           factor_stride=STRIDE,
                                           g_compress=True)
    return {"dense": (dense, precond9_to_torch(dense, N)),
            "lerp": (packed, precond9_to_torch(packed, N))}


def _close(got, ref, tol, what=""):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * np.abs(ref).max(), err_msg=what)


def _planes(P_t, n=N):
    return torch.complex(P_t.G_re[:, :, :n], P_t.G_im[:, :, :n])


def test_schur_recursion_matches_jax(sides):
    """b inversions deep, so 1e-9 (as the 5-point setup test)."""
    _, (_, jhm, _, _), (_, thm, _, _) = sides
    take = lambda H, sl: type(H)(*(getattr(H, f)[sl] for f in (
        "cc", "cw", "ce", "cs", "cn", "csw", "cse", "cnw", "cne")))
    ref = jsweep9._schur_corner_inverse9(take(jhm, slice(0, 3)))
    got = tsweep9._schur_corner_inverse9(thm.map(lambda f: f[:3]))
    _close(got, ref, 1e-9, "corner inverse")
    ref_stack = jsweep9._schur_t_stack9(take(jhm, 5))
    got_stack = tsweep9._schur_t_stack9(thm.map(lambda f: f[5]))
    assert got_stack.shape == (B, N, N)
    _close(got_stack, ref_stack, 1e-9, "T stack")
    _close(got_stack[-1], tsweep9._schur_corner_inverse9(
        thm.map(lambda f: f[5])), 1e-12, "stack top against corner")


def test_tridiagonal_products_match_dense():
    sub, dia, sup = (torch.from_numpy(random_grid(s, (N,))) for s in (1, 2, 3))
    X = torch.from_numpy(random_grid(4, (2, N, N)))
    T = torch.diag(dia) + torch.diag(sub[1:], -1) + torch.diag(sup[:-1], 1)
    _close(tsweep9._tridiag_lmatmul(sub, dia, sup, X), T @ X, 1e-13)
    _close(tsweep9._tridiag_rmatmul(X, sub, dia, sup), X @ T, 1e-13)
    _close(tsweep9._tridiag_matvec(sub, dia, sup, X[0]), X[0] @ T.T, 1e-13)


@pytest.mark.parametrize("layout", ["dense", "strided", "sampled", "compress",
                                    "compress_sampled"])
def test_setup_preconditioner9_matches_jax(sides, layout):
    """G, TF, the coupling rows and the lerp tables of every setup layout
    against JAX's; 1e-9 as the recursion above."""
    cfg, (jA, jhm, _, _), (tA, thm, _, _) = sides
    kw = {"dense": {}, "strided": dict(factor_stride=STRIDE),
          "sampled": dict(factor_stride=STRIDE, hm_sampled=True),
          "compress": dict(factor_stride=STRIDE, g_compress=True),
          "compress_sampled": dict(factor_stride=STRIDE, g_compress=True,
                                   hm_sampled=True)}[layout]
    if kw.get("hm_sampled"):
        pos = tsweep.sample_positions(M, STRIDE)
        jhm = type(jhm)(*(getattr(jhm, f)[jnp.asarray(pos)] for f in (
            "cc", "cw", "ce", "cs", "cn", "csw", "cse", "cnw", "cne")))
        thm = thm.map(lambda f: f[torch.as_tensor(pos)])
    P_j = jsweep9.setup_preconditioner9(jA, jhm, B, pad_lanes=False, **kw)
    P_t = tsweep9.setup_preconditioner9(tA, thm, B, device="cpu", **kw)
    Ms = (M - 1) // STRIDE + 2 if kw.get("g_compress") else M
    assert P_t.G_re.shape == (Ms, N, k2.g_ld(N))
    assert not P_t.G_re[:, :, N:].any()
    _close(_planes(P_t), P_j.G.cplx, 1e-9, "G")
    _close(P_t.TF, P_j.TF.cplx, 1e-9, "TF")
    for name in ("hf_l", "hf_u", "a_l", "a_u"):
        _close(getattr(P_t, name), getattr(P_j, name).cplx, 1e-12, name)
    assert P_t.g_stride == P_j.g_stride
    if P_j.g_stride:
        np.testing.assert_array_equal(to_np(P_t.g_lo), np.asarray(P_j.g_lo))
        np.testing.assert_array_equal(to_np(P_t.g_w), np.asarray(P_j.g_w))
    assert P_t.grid_shape == (N, N)


@pytest.mark.parametrize("g_compress", [False, True],
                         ids=["expanded", "compress"])
def test_assembling_setup_matches_the_staged_one(sides, g_compress):
    """The chunk-by-chunk assemble-and-factor loop gives what the staged
    setup gives for the same samples, also with a chunk smaller than the
    family (setup_chunk 4: two ragged chunks of the 7 samples)."""
    cfg, _, (tA, thm, tc, _) = sides
    pos = torch.as_tensor(tsweep.sample_positions(M, STRIDE))
    ref = tsweep9.setup_preconditioner9(
        tA, thm.map(lambda f: f[pos]), B, factor_stride=STRIDE,
        hm_sampled=True, g_compress=g_compress, device="cpu")
    got = tsweep9.setup_preconditioner9_assembling(
        tA, B, CONST, cfg.eta, cfg.omega, cfg.h, tc, gamma=2.0 / 3.0,
        factor_stride=STRIDE, g_compress=g_compress, setup_chunk=4)
    _close(_planes(got), _planes(ref), 1e-12, "G")
    _close(got.TF, ref.TF, 1e-12, "TF")
    assert got.g_stride == ref.g_stride == (STRIDE if g_compress else 0)
    with pytest.raises(ValueError, match="factor_stride > 1"):
        tsweep9.setup_preconditioner9_assembling(
            tA, B, CONST, cfg.eta, cfg.omega, cfg.h, tc, gamma=2.0 / 3.0,
            factor_stride=1)


def test_reduced_precision_storage_rounds_tf_like_jax(sides):
    """bf16 storage: TF holds bf16-rounded values on both sides (the counts
    of a solve depend on it), widened to complex128 in the port.  The
    recursions agree to 1e-9, so a rounded value may differ by one bf16 ulp
    (2^-8 relative) where it sits on a rounding edge, and nowhere by more."""
    _, (jA, jhm, _, _), (tA, thm, _, _) = sides
    P_j = jsweep9.setup_preconditioner9(jA, jhm, B, pad_lanes=False,
                                        g_dtype=jnp.bfloat16)
    P_t = tsweep9.setup_preconditioner9(tA, thm, B, g_dtype=torch.bfloat16,
                                        device="cpu")
    assert P_t.G_re.dtype == torch.bfloat16
    assert P_t.TF.dtype == torch.complex128
    tf = to_np(P_t.TF)
    np.testing.assert_array_equal(
        tf.real, to_np(P_t.TF.real.to(torch.bfloat16).to(torch.float64)))
    ref = np.asarray(P_j.TF.re.astype(jnp.float32)) \
        + 1j * np.asarray(P_j.TF.im.astype(jnp.float32))
    for got, want in ((tf.real, ref.real), (tf.imag, ref.imag)):
        assert np.all(np.abs(got - want) <= 2.0 ** -7 * np.abs(want))
    assert np.mean(tf == ref) > 0.99
    carried = precond9_to_torch(P_j, N, g_dtype=torch.bfloat16)
    assert carried.G_re.dtype == torch.bfloat16
    np.testing.assert_array_equal(to_np(carried.TF), ref)


def _tri_inputs(mode, R):
    S = M - 1 if mode == "fwd" else M
    u = random_grid(10, (S, N) if R == 1 else (S, R, N))
    c = random_grid(11, (S, 3, N))
    c[:, 0, 0] = 0            # as assembly leaves them
    c[:, 2, -1] = 0
    if mode != "fwd":
        c[-1] = 0
    carry0 = random_grid(12, (N,) if R == 1 else (R, N))
    return u, c, carry0


@pytest.mark.parametrize("kind", ["dense", "lerp"])
@pytest.mark.parametrize("R", [1, 3])
@pytest.mark.parametrize("mode", ["fwd", "bwd", "bwd_sub"])
def test_plain_sweep_tri_matches_pallas_interpret(factored, mode, R, kind):
    """Every mode x one and three right-hand sides x dense and compressed
    G, tridiagonal coupling, against the Pallas kernel in interpret mode on
    the JAX-factored G converted to the port's pitch; float64 G, 1e-10."""
    P_pad, P_t = factored[kind]
    u, c, carry0 = _tri_inputs(mode, R)
    ref = pallas_sweep(P_pad.G, CArray.of(jnp.asarray(u)),
                       CArray.of(jnp.asarray(c)),
                       CArray.of(jnp.asarray(carry0)), mode=mode,
                       interpret=True, g_lo=P_pad.g_lo,
                       g_w=P_pad.g_w).to_np()
    got = k2.sweep(P_t.G_re, P_t.G_im, torch.from_numpy(u),
                   torch.from_numpy(c), torch.from_numpy(carry0), mode=mode,
                   g_lo=P_t.g_lo, g_w=P_t.g_w)
    _close(got, ref, 1e-10, f"{mode} R={R} {kind}")


def test_plain_sweep_tri_ignores_the_two_edge_slots(factored):
    """sub[:, 0] and sup[:, n-1] multiply nothing: any value there gives the
    same sweep (the CUDA kernel is held to the same on the card), and a
    coupling with only its diagonal row is the diagonal mode."""
    _, P_t = factored["dense"]
    for mode in k2.MODES:
        u, c, carry0 = (torch.from_numpy(a) for a in _tri_inputs(mode, 3))
        ref = k2.plain_sweep(P_t.G_re, P_t.G_im, u, c, carry0, mode=mode)
        dirty = c.clone()
        dirty[:, 0, 0] = 7.0
        dirty[:, 2, -1] = float("nan")
        got = k2.plain_sweep(P_t.G_re, P_t.G_im, u, dirty, carry0, mode=mode)
        np.testing.assert_array_equal(to_np(got), to_np(ref))
        only_diag = torch.zeros_like(c)
        only_diag[:, 1] = c[:, 1]
        _close(k2.sweep(P_t.G_re, P_t.G_im, u, only_diag, carry0, mode=mode),
               k2.sweep(P_t.G_re, P_t.G_im, u, c[:, 1].contiguous(), carry0,
                        mode=mode), 1e-14)
    assert k2.launches == 0       # nothing here launches a kernel


@pytest.mark.parametrize("kind", ["dense", "lerp"])
@pytest.mark.parametrize("d2_replace", [True, False],
                         ids=["bwd", "bwd_sub"])
def test_apply_preconditioner9_matches_jax(sides, factored, d2_replace,
                                           kind):
    """The port's own setup and apply against JAX's `impl="xla"` apply, and
    the port's apply on the JAX-factored state carried across; 1e-10 (the
    setups agree to 1e-9 on G, whose errors the apply damps)."""
    import dataclasses

    _, _, (tA, thm, _, _) = sides
    P_j, P_carried = factored[kind]
    P_j = dataclasses.replace(P_j, d2_replace=d2_replace)
    P_carried = dataclasses.replace(P_carried, d2_replace=d2_replace)
    kw = dict(factor_stride=STRIDE, g_compress=True) if kind == "lerp" else {}
    P_t = tsweep9.setup_preconditioner9(tA, thm, B, d2_replace=d2_replace,
                                        device="cpu", **kw)
    f = random_grid(20, (N, N))
    ref = np.asarray(jsweep9.apply_preconditioner9(P_j, jnp.asarray(f),
                                                   impl="xla"))
    for P, what in ((P_t, "own setup"), (P_carried, "carried across")):
        got = tsweep9.apply_preconditioner9(P, torch.from_numpy(f))
        _close(got, ref, 1e-10, what)
        plain = tsweep9.apply_preconditioner9(P, torch.from_numpy(f),
                                              impl="plain")
        np.testing.assert_array_equal(to_np(got), to_np(plain))
    flat = P_t(torch.from_numpy(f.reshape(-1)))
    _close(flat, ref.reshape(-1), 1e-10, "flat call")


def test_apply_preconditioner9_multi_matches_single(factored):
    _, P_t = factored["lerp"]
    F = torch.from_numpy(random_grid(21, (3, N, N)))
    got = tsweep9.apply_preconditioner9_multi(P_t, F)
    for k in range(3):
        _close(got[k], tsweep9.apply_preconditioner9(P_t, F[k]), 1e-12,
               f"member {k}")
    _close(P_t.apply_multi(F.reshape(3, -1)), got.reshape(3, -1), 1e-14)
    with pytest.raises(ValueError, match="impl"):
        tsweep9.apply_preconditioner9(P_t, F[0], impl="pallas")


def test_preconditioner_from_samples9_matches_jax(sides, factored):
    """An already factored sample stack plus the operator: only H_F is
    factored; the result equals the compressed setup's."""
    _, (jA, _, _, _), (tA, _, _, _) = sides
    P_j, P_carried = factored["lerp"]
    got = tsweep9.preconditioner_from_samples9(
        tA, B, P_carried.G_re, P_carried.G_im, g_stride=STRIDE)
    ref = jsweep9.preconditioner_from_samples9(jA, B, P_j.G, g_stride=STRIDE)
    _close(got.TF, ref.TF.cplx, 1e-9, "TF")
    np.testing.assert_array_equal(to_np(got.g_lo), np.asarray(ref.g_lo))
    np.testing.assert_array_equal(to_np(got.g_w), np.asarray(ref.g_w))
    assert got.G_re is P_carried.G_re and got.g_stride == STRIDE
    with pytest.raises(ValueError, match="g_lo runs"):
        tsweep9.preconditioner_from_samples9(
            tA, B, P_carried.G_re[:-1], P_carried.G_im[:-1], g_stride=STRIDE)
