"""The plain reference's operator and forcings against the port's
assembly, at small n on the CPU in complex128."""
import math

import numpy as np
import pytest
import torch

from helmholtz_tpu_torch.fd import problems as fd_problems
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.ops.spmv import stencil_matvec
from reference import helmholtz as ref


def port_operator(problem, n, b, const, omega):
    h = 1.0 / (n + 1)
    c_full, _ = fd_problems.PROBLEMS[problem](
        omega, n, complex_dtype=torch.complex128, device="cpu")
    return fd_stencil.build_a_stencil(n, b, const, b * h, omega, h, c_full,
                                      fidelity="corrected",
                                      complex_dtype=torch.complex128)


@pytest.mark.parametrize("problem,medium", [("c1_f1", "c1"),
                                            ("c2_f1", "c2")])
@pytest.mark.parametrize("n,b,const,wave_num", [(31, 5, 20.0, 4.0),
                                                (63, 12, 100.0, 7.5)])
def test_operator_matches_port(problem, medium, n, b, const, wave_num):
    omega = ref.omega_of(wave_num, 2.0)
    A = port_operator(problem, n, b, const, omega)
    mine = ref.coefficients(n, b, const, omega, medium)
    for name, got in zip(("cc", "cw", "ce", "cs", "cn"), mine):
        want = getattr(A, name).numpy()
        scale = np.abs(want).max()
        assert np.abs(got - want).max() <= 1e-12 * scale, name
    u = np.random.default_rng(0).standard_normal((n, n)) + 0j
    y = stencil_matvec(A, torch.from_numpy(u)).numpy()
    assert np.allclose(ref.apply(mine, u), y, rtol=1e-12, atol=0)


@pytest.mark.parametrize("x,y", [(0.5, 0.125), (0.2131, 0.5), (0.79, 0.3)])
def test_forcing_matches_port(x, y):
    n = 63
    omega = ref.omega_of(7.25, 2.0)
    got = ref.source_f1(n, omega, x, y)
    want = fd_problems.init_f1_mat(x, y, omega, n,
                                   complex_dtype=torch.complex128,
                                   device="cpu").numpy()
    assert np.abs(got - want).max() <= 1e-13


def test_true_residual_of_exact_and_wrong_solutions():
    import scipy.sparse.linalg

    n, b, const, wn = 31, 5, 20.0, 4.0
    omega = ref.omega_of(wn, 2.0)
    A = port_operator("c1_f1", n, b, const, omega).toscipy().tocsc()
    xs, ys = (0.3, 0.6), (0.125, 0.125)
    F = [ref.source_f1(n, omega, x, y).ravel() for x, y in zip(xs, ys)]
    U = np.stack([scipy.sparse.linalg.spsolve(A, f) for f in F])
    kw = dict(n=n, b=b, const=const, alpha=2.0, wave_num=wn, medium="c1",
              xs=xs, ys=ys)
    assert max(ref.true_residuals(U, **kw)) < 1e-12
    # another frequency's operator, or the sources swapped, is caught
    assert min(ref.true_residuals(U, **dict(kw, wave_num=wn * 1.01))) > 1e-2
    assert min(ref.true_residuals(U[::-1], **kw)) > 0.5
    assert math.isclose(ref.true_residuals(0 * U, **kw)[0], 1.0)
