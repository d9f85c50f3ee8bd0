"""CPU parity of the plain versions of the port's two kernels against the
JAX package: the Pallas kernels in interpret mode and the XLA forms.

The CUDA kernels themselves run only on the card, where the smoke script at
the repository root holds them against these same plain versions.
"""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmholtz_tpu.core.complexlib import CArray, pairify
from helmholtz_tpu.ops import spmv as jspmv
from helmholtz_tpu.ops.pallas.spmv_stencil import pallas_stencil_matvec
from helmholtz_tpu.ops.pallas.sweep import pallas_sweep
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu_torch.ops import spmv as tspmv
from helmholtz_tpu_torch.ops.kernels import spmv_stencil as k1
from helmholtz_tpu_torch.ops.kernels import sweep as k2
from helmholtz_tpu_torch.precond import sweeping as tsweep

from torch_parity import (port_problems, precond_to_torch,  # noqa: F401
                          random_grid, stencil_to_torch, to_np)

N, B, WAVE, CONST = 17, 4, 1.0, 20.0


# -- K1: stencil SpMV ---------------------------------------------------------

def test_stencil_matvec_matches_pallas_interpret():
    """complex64, rtol 2e-5 of the largest entry: the tolerance the JAX
    package's own Pallas test uses (float32 sums in another order)."""
    _, jprob, _, tprob, _ = port_problems(N, B, WAVE, CONST,
                                          cdtype="complex64")
    u = random_grid(0, (N, N), np.complex64)
    ref = pallas_stencil_matvec(pairify(jprob.A), CArray.of(jnp.asarray(u)),
                                block_layers=8, interpret=True).to_np()
    got = to_np(k1.stencil_matvec(tprob.A, torch.from_numpy(u)))
    np.testing.assert_allclose(got, ref, rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())
    # the same product through the operator carried over from the JAX side
    got2 = to_np(k1.stencil_matvec(stencil_to_torch(jprob.A),
                                   torch.from_numpy(u)))
    np.testing.assert_allclose(got2, ref, rtol=2e-5,
                               atol=2e-5 * np.abs(ref).max())


def test_stencil_matvec_matches_jax_complex128():
    _, jprob, _, tprob, _ = port_problems(N, B, WAVE, CONST)
    u = random_grid(1, (N, N))
    ref = np.asarray(jspmv.stencil_matvec(jprob.A, jnp.asarray(u)))
    scale = np.abs(ref).max()
    got = to_np(tspmv.stencil_matvec(tprob.A, torch.from_numpy(u)))
    np.testing.assert_allclose(got, ref, rtol=1e-13, atol=1e-13 * scale)
    flat = to_np(tspmv.stencil_matvec_flat(tprob.A,
                                           torch.from_numpy(u.reshape(-1))))
    np.testing.assert_allclose(flat, ref.reshape(-1), rtol=1e-13,
                               atol=1e-13 * scale)
    dense = tprob.A.todense() @ u.reshape(-1)
    np.testing.assert_allclose(flat, dense, rtol=1e-12, atol=1e-12 * scale)
    # batched right-hand sides ride the leading dimension
    ub = random_grid(2, (3, N, N))
    refb = np.asarray(jspmv.stencil_matvec(jprob.A, jnp.asarray(ub)))
    gotb = to_np(tspmv.stencil_matvec(tprob.A, torch.from_numpy(ub)))
    np.testing.assert_allclose(gotb, refb, rtol=1e-13, atol=1e-13 * scale)


# -- K2: sweep recursion ------------------------------------------------------

@pytest.fixture(scope="module")
def factored():
    """One JAX-factored problem (lane-padded G, the Pallas layout) and its
    conversion to the port's layout."""
    _, jprob, jhm, _, _ = port_problems(N, B, WAVE, CONST)
    P_pad = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=True)
    assert P_pad.G.re.shape == (N - B, 128, 128)
    return jprob, jhm, P_pad, precond_to_torch(P_pad, N)


def _sweep_inputs(mode):
    S = N - B - 1 if mode == "fwd" else N - B
    u = random_grid(10, (S, N))
    c = random_grid(11, (S, N))
    if mode != "fwd":
        c[-1] = 0
    carry0 = random_grid(12, (N,))
    return u, c, carry0


@pytest.mark.parametrize("mode", ["fwd", "bwd", "bwd_sub"])
def test_plain_sweep_matches_pallas_interpret(factored, mode):
    """One case per mode against the Pallas kernel in interpret mode, on the
    JAX-factored G converted to the port's pitch; float64 G, 1e-10."""
    _, _, P_pad, P_t = factored
    u, c, carry0 = _sweep_inputs(mode)
    ref = pallas_sweep(P_pad.G, CArray.of(jnp.asarray(u)),
                       CArray.of(jnp.asarray(c)),
                       CArray.of(jnp.asarray(carry0)), mode=mode,
                       interpret=True).to_np()
    got = to_np(k2.sweep(P_t.G_re, P_t.G_im, torch.from_numpy(u),
                         torch.from_numpy(c), torch.from_numpy(carry0),
                         mode=mode))
    np.testing.assert_allclose(got, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())


@pytest.mark.parametrize("shared", [False, True], ids=["dense", "shared"])
@pytest.mark.parametrize("g_dtype", ["f32", "bf16"])
@pytest.mark.parametrize("d2_replace", [True, False],
                         ids=["bwd", "bwd_sub"])
def test_apply_grid_matches_jax_xla(d2_replace, g_dtype, shared):
    """G storage type x dense/shared stack x both backward modes against
    the JAX `impl="xla"` apply in complex64.  Both sides read the SAME
    rounded planes (factored by JAX, converted), so what differs is the
    order of the float32 sums and, for bf16 G, the JAX side's split of its
    float32 carry into two bf16 parts: 1e-5 of the largest entry."""
    problem = "c2_f1" if shared else "c1_f1"
    _, jprob, jhm, _, _ = port_problems(N, B, WAVE, CONST, problem,
                                        cdtype="complex64")
    if shared:
        jhm = type(jhm)(*(getattr(jhm, f)[:1]
                          for f in ("cc", "cw", "ce", "cs", "cn")))
    jdt = {"f32": jnp.float32, "bf16": jnp.bfloat16}[g_dtype]
    tdt = {"f32": torch.float32, "bf16": torch.bfloat16}[g_dtype]
    P_j = jsweep.setup_preconditioner(jprob.A, jhm, B, pad_lanes=False,
                                      g_dtype=jdt, d2_replace=d2_replace)
    P_t = precond_to_torch(P_j, N, g_dtype=tdt)
    assert P_t.G_re.dtype == tdt
    assert P_t.G_re.shape == (1 if shared else N - B, N, k2.g_ld(N))
    f = random_grid(20, (N, N), np.complex64)
    ref = np.asarray(jsweep.apply_preconditioner(P_j, jnp.asarray(f),
                                                 impl="xla"))
    got = to_np(tsweep.apply_preconditioner(P_t, torch.from_numpy(f)))
    np.testing.assert_allclose(got, ref, rtol=1e-5,
                               atol=1e-5 * np.abs(ref).max())
    plain = to_np(tsweep.apply_preconditioner(P_t, torch.from_numpy(f),
                                              impl="plain"))
    np.testing.assert_array_equal(got, plain)   # CPU: the same code path


def test_shared_g_matches_full_stack(factored):
    """One shared panel (Mg == 1) reproduces a stack of identical panels."""
    _, _, _, P_t = factored
    Gr = P_t.G_re[3:4].contiguous()
    Gi = P_t.G_im[3:4].contiguous()
    for mode in k2.MODES:
        u, c, carry0 = (torch.from_numpy(a) for a in _sweep_inputs(mode))
        S = u.shape[0]
        full = k2.plain_sweep(Gr.expand(S + 1, -1, -1).contiguous(),
                              Gi.expand(S + 1, -1, -1).contiguous(),
                              u, c, carry0, mode="fwd") if mode == "fwd" \
            else k2.plain_sweep(Gr.expand(S, -1, -1).contiguous(),
                                Gi.expand(S, -1, -1).contiguous(),
                                u, c, carry0, mode=mode)
        one = k2.sweep(Gr, Gi, u, c, carry0, mode=mode)
        np.testing.assert_allclose(to_np(one), to_np(full), rtol=1e-14,
                                   atol=0)


def test_g_pitch_keeps_rows_16_byte_aligned():
    for n in (17, 33, 127, 1023, 1024):
        ld = k2.g_ld(n)
        assert ld >= n and ld - n < 8
        assert (ld * 2) % 16 == 0 and (ld * 4) % 16 == 0
    assert k2.g_ld(1023) == 1024


@pytest.mark.parametrize("n", [17, 33, 1023])
@pytest.mark.parametrize("g_dtype", [torch.float32, torch.bfloat16])
def test_sweep_launch_plan_owns_every_row_once(n, g_dtype):
    """The persistent kernel's plan on a 132-SM card, for every width, kind
    of stack and coupling the wrapper takes (the coupling does not change
    the plan): the blocks cover the rows exactly once, at most one block an
    SM, and the shared memory fits a block.  The
    bf16 variants at n = 1023, every full-width path's, double-buffer G."""
    g_bytes = torch.empty((), dtype=g_dtype).element_size()
    for width, lerp, shared, tri in itertools.product(
            range(1, k2.MAX_WIDTH + 1), (False, True), (False, True),
            (False, True)):
        if lerp and shared:
            continue
        plan = k2.launch_plan(n, width, g_bytes, lerp, shared, 132)
        owned = [b * plan.rows_per_block + i for b in range(plan.blocks)
                 for i in range(plan.rows_per_block)
                 if b * plan.rows_per_block + i < n]
        assert sorted(owned) == list(range(n)), (width, lerp, shared, tri)
        assert (plan.blocks - 1) * plan.rows_per_block < n
        assert plan.blocks <= 132
        assert plan.shared_bytes <= k2.MAX_SHARED_BYTES
        stage = (plan.rows_per_block * (2 if lerp else 1) * 2 * k2.g_ld(n)
                 * g_bytes)
        assert plan.shared_bytes == 8 * width * k2.g_ld(n) \
            + plan.stages * stage
        want = 1 if shared else k2.MAX_STAGES
        if n == 1023 and g_dtype == torch.bfloat16:
            assert plan.stages == want
        else:
            assert 1 <= plan.stages <= want


def test_sweep_launch_plan_refuses_an_operand_too_large():
    with pytest.raises(ValueError, match="shared memory"):
        k2.launch_plan(8192, 4, 2, False, False, 132)


# -- the wrappers refuse what the kernels do not take -------------------------

def test_wrappers_raise_on_what_is_not_ported(factored):
    _, _, _, P_t = factored
    u, c, carry0 = (torch.from_numpy(a) for a in _sweep_inputs("bwd"))
    with pytest.raises(ValueError, match="carry0"):
        k2.sweep(P_t.G_re, P_t.G_im, u[:, None, :].expand(-1, 2, -1), c,
                 carry0, mode="bwd")
    with pytest.raises(ValueError, match=r"\(S, 3, n\)"):   # two rows
        k2.sweep(P_t.G_re, P_t.G_im, u, c[:, None, :].expand(-1, 2, -1),
                 carry0, mode="bwd")
    with pytest.raises(ValueError, match="mode"):
        k2.sweep(P_t.G_re, P_t.G_im, u, c, carry0, mode="sideways")
    with pytest.raises(ValueError, match="steps"):
        k2.sweep(P_t.G_re[:-2], P_t.G_im[:-2], u, c, carry0, mode="bwd")
    with pytest.raises(ValueError, match="planes"):
        k2.sweep(P_t.G_re[:, :, :N], P_t.G_im[:, :, :N], u, c, carry0,
                 mode="bwd")
    with pytest.raises(ValueError, match="g_stride"):
        dataclasses.replace(P_t, g_stride=4)        # tables are missing


def test_cuda_argument_checks_raise_on_wrong_dtype(factored):
    """The checks the wrappers make before a launch raise on a wrong type,
    shape or layout; nothing falls back to the plain version."""
    _, _, _, tprob, _ = port_problems(N, B, WAVE, CONST)
    _, _, _, P_t = factored
    u128 = torch.from_numpy(random_grid(30, (N, N)))
    with pytest.raises(TypeError, match="complex64"):
        k1.check_kernel_args(tprob.A, u128)
    A64 = tprob.A.map(lambda f: f.to(torch.complex64))
    u64 = u128.to(torch.complex64)
    k1.check_kernel_args(A64, u64)
    with pytest.raises(ValueError, match="shape"):
        k1.check_kernel_args(A64, u64[:-1])
    with pytest.raises(ValueError, match="contiguous"):
        k1.check_kernel_args(A64.map(lambda f: f.t()), u64)
    u, c, carry0 = (torch.from_numpy(a) for a in _sweep_inputs("bwd"))
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k2.check_kernel_args(P_t.G_re, P_t.G_im, u, c, carry0)
    G32 = P_t.G_re.float(), P_t.G_im.float()
    with pytest.raises(TypeError, match="complex64"):
        k2.check_kernel_args(*G32, u, c, carry0)
    c64 = [t.to(torch.complex64) for t in (u, c, carry0)]
    k2.check_kernel_args(*G32, *c64)
    k2.check_kernel_args(G32[0].bfloat16(), G32[1].bfloat16(), *c64)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        k2.check_kernel_args(G32[0], G32[1].bfloat16(), *c64)
    with pytest.raises(ValueError, match="contiguous"):
        k2.check_kernel_args(G32[0], G32[1], c64[0].t().contiguous().t(),
                             c64[1], c64[2])
