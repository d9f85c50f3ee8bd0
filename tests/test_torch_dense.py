"""CPU parity of the port's blocked Gauss-Jordan inverse and the plain
version of its panel kernel (K3) against the JAX package, in complex128.
Inputs are made with numpy from a seed and handed to both sides: the JAX
recursions get the port's own subgrid families, so no JAX assembly is
compiled; the Pallas kernel runs in interpret mode.
"""
import dataclasses

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


def dominant(seed, shape, scale=2.0, symmetric=False):
    """Random complex matrices with a dominant diagonal: no pivoting
    needed, as the setup's Schur complements; complex-symmetric (A^T = A)
    if asked, as the 5-point ones."""
    rng = np.random.default_rng(seed)
    k = shape[-1]
    A = (rng.standard_normal(shape) + 1j * rng.standard_normal(shape)) / k
    if symmetric:
        A = (A + np.swapaxes(A, -1, -2)) / 2
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
    assert torch.equal(tdense.batched_inverse_sym(A), torch.linalg.inv(A))
    assert k3.launches == before


# -- the symmetric route ------------------------------------------------------

#: SYM_PRODUCT_ROWS that give one block row a product (the setup's
#: batches) and one product a region (a batch of one) at these sizes
GROUPINGS = {"by_row": 1, "by_region": 1 << 20}


@pytest.mark.parametrize("grouping", GROUPINGS)
@pytest.mark.parametrize("n", [33, 70, 150, 200, 300])
def test_blocked_gj_sym_matches_the_general_route(n, grouping, monkeypatch):
    """n = 33: the scalar Gauss-Jordan of the mirrored matrix; n = 70: an
    identity tail (64 -> 128); 150: panels of 75; 200, 300: an outer pad
    (100 -> 200, 150 -> 300, inner 64 -> 128 / 192).  The same unpivoted
    arithmetic as `_blocked_gj` in another order: 1e-11, and an exactly
    symmetric result, whichever the grouping of the update products."""
    monkeypatch.setattr(tdense, "SYM_PRODUCT_ROWS", GROUPINGS[grouping])
    A = torch.from_numpy(dominant(11 + n, (2, n, n), symmetric=True))
    got = tdense._blocked_gj_sym(A, 256)
    assert got.shape == (2, n, n)
    assert torch.equal(got, got.mT)
    _close(got, tdense._blocked_gj(A, 256), 1e-11, "against _blocked_gj")
    _close(got, np.linalg.inv(A.numpy()), 1e-11, "against LAPACK")


@pytest.mark.parametrize("n", [33, 70, 200])
def test_blocked_gj_sym_reads_only_the_lower_triangle(n):
    """Anything above the diagonal leaves the result unchanged, bit for
    bit."""
    A = torch.from_numpy(dominant(21 + n, (2, n, n), symmetric=True))
    junk = torch.from_numpy(dominant(31 + n, (2, n, n))).triu(1) * 1e3
    assert torch.equal(tdense._blocked_gj_sym(A + junk, 256),
                       tdense._blocked_gj_sym(A, 256))


@pytest.mark.parametrize("n,general,sym", [(1023, 1.60, 0.66),
                                            (2047, 1.28, 0.57)])
def test_blocked_gj_flops_count_the_stated_work(n, general, sym):
    """The operations of one inverse, in units of n^3 complex multiply-adds,
    as `_blocked_gj_sym`'s docstring states them."""
    unit = 8.0 * n ** 3
    assert tdense.blocked_gj_flops(n) / unit == pytest.approx(general,
                                                              abs=0.01)
    assert tdense.blocked_gj_flops(n, symmetric=True) / unit == \
        pytest.approx(sym, abs=0.01)


def _general_route(A, block):
    """`_blocked_gj` looked up at call time, so that its recursion is seen
    through a patched name."""
    return tdense._blocked_gj(A, block)


def _work_matrices(monkeypatch, fn, A, n_pad):
    """The (B, n_pad, n_pad) work matrix of `fn` at the start of each of
    its panel steps, and its result: read through the panel inverse's
    argument, a view into the work matrix."""
    plain = tdense._blocked_gj
    seen = []

    def spy(P, block):
        base = P._base
        if base is not None and base.shape[-1] == n_pad:
            seen.append(base.clone())
        return plain(P, block)

    monkeypatch.setattr(tdense, "_blocked_gj", spy)
    X = fn(A, 64)
    monkeypatch.setattr(tdense, "_blocked_gj", plain)
    return seen + [X]


@pytest.mark.parametrize("grouping", GROUPINGS)
def test_blocked_gj_sym_keeps_the_symmetric_invariant(grouping, monkeypatch):
    """On a symmetric A, the general route's work matrix satisfies
    X^T = J X J at every step (J = +1 on the panels done, -1 on the rest),
    and the symmetric route's lower block triangle, diagonal panels whole,
    is the general route's at every step."""
    monkeypatch.setattr(tdense, "SYM_PRODUCT_ROWS", GROUPINGS[grouping])
    n, nb = 256, 64
    A = torch.from_numpy(dominant(41, (2, n, n), symmetric=True))
    general = _work_matrices(monkeypatch, _general_route, A, n)
    sym = _work_matrices(monkeypatch, tdense._blocked_gj_sym, A, n)
    assert len(general) == len(sym) == n // nb + 1
    scale = general[-1].abs().max()
    blocks = torch.arange(n) // nb
    lower = blocks[:, None] >= blocks[None, :]
    for k, (Xg, Xs) in enumerate(zip(general, sym)):
        J = torch.where(blocks < k, 1.0, -1.0).to(Xg.dtype)
        JXJ = J[:, None] * Xg * J[None, :]
        assert (Xg.mT - JXJ).abs().max() <= 1e-12 * scale, k
        assert (torch.where(lower, Xs - Xg, 0).abs().max()
                <= 1e-12 * scale), k


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


def _gj_sym_route(A):
    """`batched_inverse_sym` as it runs on the card, with the plain panel
    inverse in place of the kernel."""
    n = A.shape[-1]
    return tdense._blocked_gj_sym(A.reshape(-1, n, n), 256).reshape(A.shape)


def _refused(A):
    raise AssertionError("a symmetric family reached the general route")


def test_5pt_g_stack_through_gauss_jordan_matches_jax(monkeypatch):
    """Every Schur block of the n = 33 setup inverted by the general
    blocked Gauss-Jordan (padded 33 -> 64): the G stack and H_F's T stack
    against the JAX recursion (pivoted LAPACK) on the same family, to 1e-9
    of the largest entry, as the LAPACK parity test of the setup."""
    A, hm = _family(B5, 20.0, nine=False)
    HF = tstencil.extract_hf_stencil(A, B5, full_coupling=True)
    monkeypatch.setattr(tsweep, "batched_inverse", _gj_route)
    monkeypatch.setattr(tsweep, "batched_inverse_sym", _gj_route)
    P = tsweep.setup_preconditioner(A, hm, B5, device="cpu")
    G_ref = jax.jit(jsweep._schur_corner_inverse)(to_jax(hm))
    _close(torch.complex(P.G_re[:, :, :N], P.G_im[:, :, :N]), G_ref, 1e-9,
           "G")
    TF_ref = jax.jit(jsweep._schur_t_stack)(to_jax(HF))
    _close(P.TF, TF_ref, 1e-9, "TF")


def test_5pt_g_stack_through_symmetric_gauss_jordan_matches_jax(monkeypatch):
    """The same setup with every Schur block through the symmetric route
    (the family is complex-symmetric, so none reaches the general one):
    the G stack and H_F's T stack against the JAX recursion to 1e-9."""
    A, hm = _family(B5, 20.0, nine=False)
    HF = tstencil.extract_hf_stencil(A, B5, full_coupling=True)
    monkeypatch.setattr(tsweep, "batched_inverse", _refused)
    monkeypatch.setattr(tsweep, "batched_inverse_sym", _gj_sym_route)
    P = tsweep.setup_preconditioner(A, hm, B5, device="cpu")
    G_ref = jax.jit(jsweep._schur_corner_inverse)(to_jax(hm))
    _close(torch.complex(P.G_re[:, :, :N], P.G_im[:, :, :N]), G_ref, 1e-9,
           "G")
    TF_ref = jax.jit(jsweep._schur_t_stack)(to_jax(HF))
    _close(P.TF, TF_ref, 1e-9, "TF")


def _perturbed(H):
    cs = H.cs.clone()
    cs[..., 3, 5] *= 1.001
    return dataclasses.replace(H, cs=cs)


@pytest.mark.parametrize("case,route", [
    ("symmetric", "sym"), ("one_cs_perturbed", "general"),
    ("nine_point", "general")])
def test_schur_blocks_route_by_observed_symmetry(case, route):
    """The port's complex64 5-point family and its H_F are complex-symmetric
    to the bit and take only the symmetric route; the same family with one
    cs entry moved, and the 9-point family, take only the general one."""
    cfg = ht.HelmholtzConfig(n=N, b=B5, wave_num=WAVE, const=20.0)
    prob = ht.assemble_problem(cfg, device="cpu")
    args = (N, B5, 20.0, cfg.eta, cfg.omega, cfg.h, prob.c_full)
    kw = dict(fidelity="corrected", complex_dtype=torch.complex64)
    tdense.reset_counts()
    if case == "nine_point":
        tsweep9._schur_corner_inverse9(tstencil.build_hm_stencils9(
            *args, **kw).map(lambda f: f[:4]))
        tsweep9._schur_t_stack9(tstencil.build_hf_stencil9(*args, **kw))
    else:
        hm = tstencil.build_hm_stencils(*args, **kw).map(lambda f: f[:4])
        HF = tstencil.build_hf_stencil(*args, **kw)
        if case == "one_cs_perturbed":
            hm, HF = _perturbed(hm), _perturbed(HF)
        tsweep._schur_corner_inverse(hm)
        tsweep._schur_t_stack(HF)
    other = "general" if route == "sym" else "sym"
    # four subgrids' and H_F's B5 layer blocks each
    assert tdense.inverses_by_route == {route: 4 * B5 + B5, other: 0}


def test_9pt_g_stack_through_gauss_jordan_matches_jax(monkeypatch):
    """The 9-point corner inverses at n = 33 through the blocked
    Gauss-Jordan, against the JAX recursion on the same subgrids: 1e-9."""
    _, hm9 = _family(B9, 30.0, nine=True)
    part = hm9.map(lambda f: f[:4])
    monkeypatch.setattr(tsweep9, "batched_inverse", _gj_route)
    got = tsweep9._schur_corner_inverse9(part)
    ref = jax.jit(jsweep9._schur_corner_inverse9)(to_jax(part))
    _close(got, ref, 1e-9, "corner inverses")
