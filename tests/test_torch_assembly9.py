"""CPU parity of the port's 9-point assembly and operator product against
the JAX package, in complex128 on tiny grids.

Inputs that are not derived from the configuration are made with numpy from
a seed and handed to both sides.  Assembly is the same closed-form
arithmetic on both sides, so the tolerance is 1e-12 of each field's largest
entry.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmholtz_tpu.fd import stencil as jstencil
from helmholtz_tpu.ops import spmv as jspmv
from helmholtz_tpu_torch.fd import stencil as tstencil
from helmholtz_tpu_torch.ops import spmv as tspmv

from torch_parity import (FIELDS, FIELDS9, assert_stencils_close,  # noqa: F401
                          both_problems9, random_grid, stencil9_to_torch,
                          to_np)

N, B, WAVE, CONST = 27, 5, 2.0, 30.0
TOL = 1e-12


@pytest.fixture(scope="module", params=["corrected", "as-shipped"])
def sides(request):
    return (request.param,) + both_problems9(N, B, WAVE, CONST,
                                             fidelity=request.param)


def _args(cfg, c_full):
    return (N, B, CONST, cfg.eta, cfg.omega, cfg.h, c_full)


def test_a_stencil9_matches_jax(sides):
    fidelity, cfg, (jA, _, jc, _), (tA, _, tc, _) = sides
    assert_stencils_close(tA, jA, TOL, f"A9 {fidelity}")
    assert tA.cc.shape == (N, N) and tA.dtype == torch.complex128
    # a band of rows anywhere in the grid, the ends included
    rows = np.array([0, 3, N - 2, N - 1])
    kw = dict(gamma=0.6, fidelity=fidelity)
    ref = jstencil.build_a_stencil9_rows(
        jnp.asarray(rows), *_args(cfg, jc), **kw,
        complex_dtype=jnp.complex128)
    got = tstencil.build_a_stencil9_rows(
        torch.as_tensor(rows), *_args(cfg, tc), **kw,
        complex_dtype=torch.complex128)
    assert_stencils_close(got, ref, TOL, f"A9 rows {fidelity}")


def test_a_stencil9_without_mehrstellen_matches_jax(sides):
    fidelity, cfg, (_, _, jc, _), (_, _, tc, _) = sides
    kw = dict(mehrstellen=False, fidelity=fidelity)
    ref = jstencil.build_a_stencil9(*_args(cfg, jc), **kw,
                                    complex_dtype=jnp.complex128)
    got = tstencil.build_a_stencil9(*_args(cfg, tc), **kw,
                                    complex_dtype=torch.complex128)
    assert_stencils_close(got, ref, TOL, f"A9 point mass {fidelity}")


def test_hf_stencil9_matches_jax(sides):
    fidelity, cfg, (jA, _, jc, _), (tA, _, tc, _) = sides
    ref = jstencil.extract_hf_stencil9(jA, B)
    got = tstencil.extract_hf_stencil9(tA, B)
    assert_stencils_close(got, ref, TOL, "extract H_F9")
    built = tstencil.build_hf_stencil9(*_args(cfg, tc), fidelity=fidelity,
                                       complex_dtype=torch.complex128)
    ref_built = jstencil.build_hf_stencil9(*_args(cfg, jc),
                                           fidelity=fidelity,
                                           complex_dtype=jnp.complex128)
    assert_stencils_close(built, ref_built, TOL, "build H_F9")
    assert_stencils_close(built, ref, TOL, "built against extracted H_F9")
    for f in ("cn", "cnw", "cne"):
        assert not getattr(got, f)[B - 1].any()


@pytest.mark.parametrize("rows", [None, [B, B + 4, N - 1]],
                         ids=["all", "rows"])
def test_hm_stencils9_matches_jax(sides, rows):
    fidelity, cfg, (_, jhm, jc, _), (_, thm, tc, _) = sides
    if rows is not None:
        kw = dict(fidelity=fidelity)
        jhm = jstencil.build_hm_stencils9(*_args(cfg, jc), **kw,
                                          complex_dtype=jnp.complex128,
                                          rows=jnp.asarray(rows))
        thm = tstencil.build_hm_stencils9(*_args(cfg, tc), **kw,
                                          complex_dtype=torch.complex128,
                                          rows=torch.as_tensor(rows))
    assert thm.cc.shape == ((N - B) if rows is None else len(rows), B, N)
    assert_stencils_close(thm, jhm, TOL, f"H_m9 {fidelity}")


def test_mass_filter9_matches_jax(sides):
    _, cfg, (_, _, _, jf), (_, _, _, tf) = sides
    args = (N, B, CONST, cfg.eta, cfg.omega, cfg.h)
    ref = np.asarray(jstencil.mass_filter9(*args, jnp.asarray(jf)))
    got = to_np(tstencil.mass_filter9(*args, tf))
    np.testing.assert_allclose(got, ref, rtol=TOL,
                               atol=TOL * np.abs(ref).max())
    # a batch of seeded grids in one pass
    F = random_grid(3, (3, N, N))
    refb = np.asarray(jstencil.mass_filter9(*args, jnp.asarray(F)))
    gotb = to_np(tstencil.mass_filter9(*args, torch.from_numpy(F)))
    np.testing.assert_allclose(gotb, refb, rtol=TOL,
                               atol=TOL * np.abs(refb).max())
    same = tstencil.mass_filter9(*args, torch.from_numpy(F),
                                 mehrstellen=False)
    np.testing.assert_array_equal(to_np(same), F)


def test_stencil9_matvec_matches_jax(sides):
    _, _, (jA, _, _, _), (tA, _, _, _) = sides
    u = random_grid(1, (N, N))
    ref = np.asarray(jspmv.stencil9_matvec(jA, jnp.asarray(u)))
    scale = np.abs(ref).max()
    got = to_np(tspmv.stencil9_matvec(tA, torch.from_numpy(u)))
    np.testing.assert_allclose(got, ref, rtol=TOL, atol=TOL * scale)
    # the JAX-assembled operator, converted, gives the same product
    got2 = to_np(tspmv.stencil9_matvec(stencil9_to_torch(jA),
                                       torch.from_numpy(u)))
    np.testing.assert_allclose(got2, ref, rtol=TOL, atol=TOL * scale)
    flat = to_np(tspmv.stencil9_matvec_flat(
        tA, torch.from_numpy(u.reshape(-1))))
    dense = tA.todense() @ u.reshape(-1)
    np.testing.assert_allclose(flat, dense, rtol=TOL, atol=TOL * scale)
    np.testing.assert_allclose(tA.todense(), np.asarray(jA.todense()),
                               rtol=TOL, atol=TOL * scale)
    ub = random_grid(2, (3, N, N))
    refb = np.asarray(jspmv.stencil9_matvec(jA, jnp.asarray(ub)))
    gotb = to_np(tspmv.stencil9_matvec(tA, torch.from_numpy(ub)))
    np.testing.assert_allclose(gotb, refb, rtol=TOL, atol=TOL * scale)


def test_gamma_one_reproduces_the_5_point_operator(sides):
    """The limit that pins the construction: gamma = 1 with the point mass
    is `build_a_stencil`, corner couplings zero."""
    fidelity, cfg, _, (_, _, tc, _) = sides
    five = tstencil.build_a_stencil(*_args(cfg, tc), fidelity=fidelity)
    nine = tstencil.build_a_stencil9(*_args(cfg, tc), gamma=1.0,
                                     mehrstellen=False, fidelity=fidelity)
    for f in FIELDS:
        np.testing.assert_allclose(to_np(getattr(nine, f)),
                                   to_np(getattr(five, f)), rtol=1e-13,
                                   atol=0)
    for f in FIELDS9[5:]:
        assert not getattr(nine, f).any()
