"""CPU parity of the port's blocked Gauss-Jordan inverse and the plain
version of its panel kernel (K3) against the JAX package, in complex128.
Inputs are made with numpy from a seed and handed to both sides: the JAX
recursions get the port's own subgrid families, so no JAX assembly is
compiled; the Pallas kernel runs in interpret mode.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu.core.complexlib import CArray
from helmholtz_tpu.ops import dense as jdense
from helmholtz_tpu.ops.pallas.gj_inverse import pallas_gj_inverse
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu.precond import sweeping9 as jsweep9
from helmholtz_tpu_torch.fd import stencil as tstencil
from helmholtz_tpu_torch.ops import dense as tdense
from helmholtz_tpu_torch.ops.kernels import gj_inverse as k3
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.precond import sweeping9 as tsweep9

from torch_parity import to_jax, to_np


def dominant(seed, shape, scale=2.0):
    """Random complex matrices with a dominant diagonal: no pivoting
    needed, as the setup's Schur complements."""
    rng = np.random.default_rng(seed)
    k = shape[-1]
    A = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / k
    return A + scale * np.eye(k)


def _close(got, ref, tol, what=""):
    got, ref = to_np(got), to_np(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * np.abs(ref).max(), err_msg=what)


# -- K3's plain version -------------------------------------------------------

def test_plain_gj_matches_jax_scalar_gauss_jordan():
    """The same k rank-1 steps as the JAX loop: agreement to rounding."""
    A = dominant(0, (3, 64, 64))
    got = k3.gauss_jordan_inverse_unpivoted(torch.from_numpy(A))
    _close(got, jdense.gauss_jordan_inverse_unpivoted(jnp.asarray(A)),
           1e-13)
    _close(got, np.linalg.inv(A), 1e-12, "against LAPACK")


def test_plain_gj_matches_pallas_kernel_in_interpret_mode():
    A = dominant(1, (3, 64, 64))
    ref = pallas_gj_inverse(CArray.of(jnp.asarray(A)), interpret=True)
    _close(k3.gauss_jordan_inverse_unpivoted(torch.from_numpy(A)),
           ref.to_np(), 1e-12)


def test_gj_wrapper_takes_its_plain_version_on_the_cpu():
    A = torch.from_numpy(dominant(2, (2, 33, 33))).to(torch.complex64)
    before = k3.launches
    got = k3.gj_inverse(A)
    assert k3.launches == before
    assert torch.equal(got, k3.gauss_jordan_inverse_unpivoted(A))
    assert not torch.equal(got, A)           # the input is left alone


@pytest.mark.parametrize("k", [17, 33])
def test_plain_gj_of_an_identity_tail_keeps_the_leading_block(k):
    """The identity the kernel's padding relies on: a k x k matrix runs in
    the next template width (64) as blockdiag(A, I), whose Gauss-Jordan
    inverse is blockdiag(A^-1, I), step for step the same arithmetic on
    the leading block."""
    A = torch.from_numpy(dominant(7 + k, (2, k, k)))
    padded = torch.eye(64, dtype=A.dtype).repeat(2, 1, 1)
    padded[:, :k, :k] = A
    got = k3.gauss_jordan_inverse_unpivoted(padded)
    ref = k3.gauss_jordan_inverse_unpivoted(A)
    _close(got[:, :k, :k], ref, 1e-14)
    assert torch.equal(got[:, k:, k:], torch.eye(64 - k,
                                                 dtype=A.dtype).expand(
                                                     2, -1, -1))
    assert not got[:, :k, k:].any() and not got[:, k:, :k].any()


@pytest.mark.parametrize("bad,error", [
    (torch.zeros((2, 8, 8), dtype=torch.complex128), TypeError),
    (torch.zeros((1, 129, 129), dtype=torch.complex64), ValueError),
    (torch.zeros((8, 8), dtype=torch.complex64), ValueError),
    (torch.zeros((2, 8, 16), dtype=torch.complex64)[:, :, ::2], ValueError),
])
def test_gj_kernel_contract_is_checked(bad, error):
    """What the kernel refuses is refused before a launch."""
    with pytest.raises(error):
        k3.check_kernel_args(bad)


# -- the blocked inverse ------------------------------------------------------

@pytest.mark.parametrize("n", [150, 200])
def test_blocked_gj_matches_jax(n):
    """n = 150: panels of 75, each through the inner identity-padded
    recursion (64 -> 128); n = 200: an outer pad (100 -> 200, inner 64 ->
    128).  The same unpivoted arithmetic on both sides: 1e-12."""
    A = dominant(3 + n, (2, n, n))
    got = tdense._blocked_gj(torch.from_numpy(A), 256)
    assert got.shape == (2, n, n)
    _close(got, jdense._blocked_gj(jnp.asarray(A), 256, None), 1e-12)
    _close(got, np.linalg.inv(A), 1e-11, "against LAPACK")


def test_blocked_gj_pads_with_an_identity_tail():
    """n = 70 is padded to 128 by the panel of 64; the result is the
    leading block and the padding never leaks into it."""
    A = dominant(5, (1, 70, 70))
    got = tdense._blocked_gj(torch.from_numpy(A), 256)
    _close(got, np.linalg.inv(A), 1e-12)


@pytest.mark.parametrize("dtype", [torch.complex128, torch.complex64])
def test_batched_inverse_routes_by_device(dtype):
    """On the CPU both routes are `torch.linalg.inv`: the CPU setups keep
    the reference numerics, and the panel kernel is not reached."""
    A = torch.from_numpy(dominant(6, (2, 3, 40, 40))).to(dtype)
    before = k3.launches
    for pivoted in (False, True):
        assert torch.equal(tdense.batched_inverse(A, pivoted=pivoted),
                           torch.linalg.inv(A))
    assert k3.launches == before


# -- the setups through the Gauss-Jordan route --------------------------------

N, B5, B9, WAVE = 33, 6, 4, 2.0


def _gj_route(A):
    """`batched_inverse` as it runs on the card, with the plain panel
    inverse in place of the kernel."""
    n = A.shape[-1]
    return tdense._blocked_gj(A.reshape(-1, n, n), 256).reshape(A.shape)


def _family(b, const, nine):
    """The port's n = 33 operator and subgrid family (complex128, CPU)."""
    cfg = ht.HelmholtzConfig(n=N, b=b, wave_num=WAVE, const=const)
    prob = ht.assemble_problem(cfg, device="cpu")
    args = (N, b, const, cfg.eta, cfg.omega, cfg.h, prob.c_full)
    kw = dict(fidelity="corrected", complex_dtype=torch.complex128)
    if nine:
        return (tstencil.build_a_stencil9(*args, **kw),
                tstencil.build_hm_stencils9(*args, **kw))
    return prob.A, tstencil.build_hm_stencils(*args, **kw)


def test_5pt_g_stack_through_gauss_jordan_matches_jax(monkeypatch):
    """Every Schur block of the n = 33 setup inverted by the blocked
    Gauss-Jordan (padded 33 -> 64): the G stack and H_F's T stack against
    the JAX recursion (pivoted LAPACK) on the same family, to 1e-9 of the
    largest entry, as the LAPACK parity test of the setup."""
    A, hm = _family(B5, 20.0, nine=False)
    HF = tstencil.extract_hf_stencil(A, B5, full_coupling=True)
    monkeypatch.setattr(tsweep, "batched_inverse", _gj_route)
    P = tsweep.setup_preconditioner(A, hm, B5, device="cpu")
    G_ref = jax.jit(jsweep._schur_corner_inverse)(to_jax(hm))
    _close(torch.complex(P.G_re[:, :, :N], P.G_im[:, :, :N]), G_ref, 1e-9,
           "G")
    TF_ref = jax.jit(jsweep._schur_t_stack)(to_jax(HF))
    _close(P.TF, TF_ref, 1e-9, "TF")


def test_9pt_g_stack_through_gauss_jordan_matches_jax(monkeypatch):
    """The 9-point corner inverses at n = 33 through the blocked
    Gauss-Jordan, against the JAX recursion on the same subgrids: 1e-9."""
    _, hm9 = _family(B9, 30.0, nine=True)
    part = hm9.map(lambda f: f[:4])
    monkeypatch.setattr(tsweep9, "batched_inverse", _gj_route)
    got = tsweep9._schur_corner_inverse9(part)
    ref = jax.jit(jsweep9._schur_corner_inverse9)(to_jax(part))
    _close(got, ref, 1e-9, "corner inverses")
