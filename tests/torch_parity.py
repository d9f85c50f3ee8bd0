"""Shared helpers of the port's parity tests: build one problem in both
packages on the CPU in complex128 and move state between them as numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu.fd import stencil as jstencil
from helmholtz_tpu_torch import convert
from helmholtz_tpu_torch.fd import stencil as tstencil

FIELDS = ("cc", "cw", "ce", "cs", "cn")


@pytest.fixture(scope="module", autouse=True)
def single_thread():
    """The grids here are tiny; one thread keeps the port's side from
    competing with parallel test workers for cores.  A test module takes
    this fixture by importing it, and the old setting comes back when the
    module is done."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def to_np(x):
    """numpy view of a torch tensor, a jax array or a split-real pair."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "to_np"):
        return x.to_np()
    return np.asarray(x)


def assert_stencils_close(t_stencil, j_stencil, rtol, what=""):
    for name in FIELDS:
        got = to_np(getattr(t_stencil, name))
        ref = to_np(getattr(j_stencil, name))
        assert got.shape == ref.shape, (what, name, got.shape, ref.shape)
        np.testing.assert_allclose(
            got, ref, rtol=rtol, atol=rtol * np.abs(ref).max(),
            err_msg=f"{what} field {name}")


def both_problems(n, b, wave_num, const, problem="c1_f1",
                  fidelity="corrected", cdtype="complex128"):
    """(cfg, jax Problem, jax hm, torch Problem, torch hm) of one config."""
    jcd = {"complex128": jnp.complex128, "complex64": jnp.complex64}[cdtype]
    tcd = {"complex128": torch.complex128,
           "complex64": torch.complex64}[cdtype]
    jcfg = hj.HelmholtzConfig(n=n, b=b, wave_num=wave_num, const=const,
                              fidelity=fidelity)
    tcfg = ht.HelmholtzConfig(n=n, b=b, wave_num=wave_num, const=const,
                              fidelity=fidelity)
    jprob = hj.assemble_problem(jcfg, problem, complex_dtype=jcd)
    jhm = jstencil.build_hm_stencils(n, b, const, jcfg.eta, jcfg.omega,
                                     jcfg.h, jprob.c_full, fidelity=fidelity,
                                     complex_dtype=jcd)
    tprob = ht.assemble_problem(tcfg, problem, complex_dtype=tcd,
                                device="cpu")
    thm = tstencil.build_hm_stencils(n, b, const, tcfg.eta, tcfg.omega,
                                     tcfg.h, tprob.c_full, fidelity=fidelity,
                                     complex_dtype=tcd)
    return tcfg, jprob, jhm, tprob, thm


def stencil_to_torch(j_stencil):
    """The port's Stencil5 (CPU) from a JAX-assembled one."""
    return convert.stencil5_from_numpy(
        *(to_np(getattr(j_stencil, f)) for f in FIELDS), device="cpu")


def precond_to_torch(P, n, *, g_dtype=None):
    """The port's SweepingPreconditioner (CPU) from a JAX-factored one; a
    reduced-precision G is passed through float32, which holds every
    bfloat16 value exactly.  A sample-compressed stack keeps its tables."""
    g = lambda a: np.asarray(jnp.asarray(a, jnp.float32)
                             if a.dtype == jnp.bfloat16 else a)
    return convert.preconditioner_from_numpy(
        g(P.G.re), g(P.G.im), P.TF.to_np(), P.hf_cs.to_np(),
        P.hf_cn.to_np(), P.a_cs.to_np(), P.a_cn.to_np(), P.b, P.d2_replace,
        n, g_dtype=g_dtype, device="cpu",
        **(dict(g_w=np.asarray(P.g_w), g_lo=np.asarray(P.g_lo),
                g_stride=P.g_stride) if P.g_stride else {}))


def random_grid(seed, shape, dtype=np.complex128):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape)
            + 1j * rng.standard_normal(shape)).astype(dtype)
