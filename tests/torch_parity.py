"""Shared helpers of the port's parity tests: build one problem in both
packages on the CPU in complex128 and move state between them as numpy."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu.core import sparse as jsparse
from helmholtz_tpu.fd import assembly as jassembly
from helmholtz_tpu.fd import stencil as jstencil
from helmholtz_tpu_torch import convert
from helmholtz_tpu_torch.fd import stencil as tstencil

FIELDS = ("cc", "cw", "ce", "cs", "cn")
FIELDS9 = FIELDS + ("csw", "cse", "cnw", "cne")


def to_np(x):
    """numpy view of a torch tensor, a jax array or a split-real pair."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if hasattr(x, "to_np"):
        return x.to_np()
    return np.asarray(x)


def assert_stencils_close(t_stencil, j_stencil, rtol, what=""):
    """Every field of a Stencil5, or of a Stencil9, against its JAX twin."""
    for name in (FIELDS9 if hasattr(j_stencil, "csw") else FIELDS):
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


def to_jax(x):
    """A JAX array (or Stencil) holding a copy of a port tensor (or
    Stencil)."""
    if isinstance(x, (ht.Stencil5, ht.Stencil9)):
        cls = jsparse.Stencil5 if isinstance(x, ht.Stencil5) \
            else jsparse.Stencil9
        return cls(*(jnp.asarray(to_np(f)) for f in x.fields()))
    return jnp.asarray(to_np(x))


def port_problems(n, b, wave_num, const, problem="c1_f1",
                  fidelity="corrected", cdtype="complex128"):
    """`both_problems` for the parity tests of what comes after assembly:
    the JAX side holds the port's own operator, forcing and subgrid family,
    so no JAX assembly is compiled.  The assembly itself is held against
    the JAX package by `test_torch_assembly.py` (to 1e-12)."""
    tcd = {"complex128": torch.complex128,
           "complex64": torch.complex64}[cdtype]
    tcfg = ht.HelmholtzConfig(n=n, b=b, wave_num=wave_num, const=const,
                              fidelity=fidelity)
    tprob = ht.assemble_problem(tcfg, problem, complex_dtype=tcd,
                                device="cpu")
    thm = tstencil.build_hm_stencils(n, b, const, tcfg.eta, tcfg.omega,
                                     tcfg.h, tprob.c_full, fidelity=fidelity,
                                     complex_dtype=tcd)
    jprob = jassembly.Problem(A=to_jax(tprob.A),
                              c_full=to_jax(tprob.c_full),
                              f_grid=to_jax(tprob.f_grid))
    return tcfg, jprob, to_jax(thm), tprob, thm


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


def both_problems9(n, b, wave_num, const, problem="c1_f1",
                   fidelity="corrected", gamma=2.0 / 3.0, rows=None):
    """The 9-point scheme of one config in complex128 on both sides:
    (cfg, jax (A9, hm9, c_full, f_grid), torch (A9, hm9, c_full, f_grid)).
    `rows` restricts both subgrid families to those grid rows."""
    jcfg = hj.HelmholtzConfig(n=n, b=b, wave_num=wave_num, const=const,
                              fidelity=fidelity)
    tcfg = ht.HelmholtzConfig(n=n, b=b, wave_num=wave_num, const=const,
                              fidelity=fidelity)
    jprob = hj.assemble_problem(jcfg, problem, complex_dtype=jnp.complex128)
    tprob = ht.assemble_problem(tcfg, problem, complex_dtype=torch.complex128,
                                device="cpu")
    sides = []
    for mod, cfg, prob, cd, as_rows in (
            (jstencil, jcfg, jprob, jnp.complex128, jnp.asarray),
            (tstencil, tcfg, tprob, torch.complex128, torch.as_tensor)):
        args = (n, b, const, cfg.eta, cfg.omega, cfg.h, prob.c_full)
        kw = dict(gamma=gamma, fidelity=fidelity, complex_dtype=cd)
        A9 = mod.build_a_stencil9(*args, **kw)
        hm9 = mod.build_hm_stencils9(
            *args, **kw, rows=None if rows is None else as_rows(rows))
        sides.append((A9, hm9, prob.c_full, prob.f_grid))
    return tcfg, sides[0], sides[1]


def port_problems9(n, b, wave_num, const, problem="c1_f1",
                   fidelity="corrected", gamma=2.0 / 3.0):
    """`both_problems9` for the parity tests of what comes after assembly:
    both sides hold the port's 9-point operator, family, velocity and
    forcing (the 9-point assembly is held against the JAX package by
    `test_torch_assembly9.py`), so no JAX assembly is compiled."""
    tcfg = ht.HelmholtzConfig(n=n, b=b, wave_num=wave_num, const=const,
                              fidelity=fidelity)
    tprob = ht.assemble_problem(tcfg, problem, complex_dtype=torch.complex128,
                                device="cpu")
    args = (n, b, const, tcfg.eta, tcfg.omega, tcfg.h, tprob.c_full)
    kw = dict(gamma=gamma, fidelity=fidelity, complex_dtype=torch.complex128)
    side = (tstencil.build_a_stencil9(*args, **kw),
            tstencil.build_hm_stencils9(*args, **kw), tprob.c_full,
            tprob.f_grid)
    return tcfg, tuple(to_jax(x) for x in side), side


def stencil9_to_torch(j_stencil):
    """The port's Stencil9 (CPU) from a JAX-assembled one."""
    return convert.stencil9_from_numpy(
        *(to_np(getattr(j_stencil, f)) for f in FIELDS9), device="cpu")


def precond9_to_torch(P, n, *, g_dtype=None):
    """The port's SweepingPreconditioner9 (CPU) from a JAX-factored one; a
    reduced-precision G or TF is passed through float32, which holds every
    bfloat16 value exactly, and TF is widened to the coupling rows' type as
    the port keeps it.  A sample-compressed stack keeps its tables."""
    g = lambda a: np.asarray(jnp.asarray(a, jnp.float32)
                             if a.dtype == jnp.bfloat16 else a)
    cd = P.a_l.to_np().dtype
    TF = (g(P.TF.re) + 1j * g(P.TF.im)).astype(cd)
    return convert.preconditioner9_from_numpy(
        g(P.G.re), g(P.G.im), TF, P.hf_l.to_np(), P.hf_u.to_np(),
        P.a_l.to_np(), P.a_u.to_np(), P.b, P.d2_replace, n, g_dtype=g_dtype,
        device="cpu",
        **(dict(g_w=np.asarray(P.g_w), g_lo=np.asarray(P.g_lo),
                g_stride=P.g_stride) if P.g_stride else {}))
