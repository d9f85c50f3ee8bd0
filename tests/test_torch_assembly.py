"""CPU parity of the port's assembly against the JAX package, plus the
port's import hygiene and device contract."""
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu.fd import stencil as jstencil
from helmholtz_tpu_torch.fd import stencil as tstencil

from torch_parity import (assert_stencils_close, both_problems,  # noqa: F401
                          single_thread, to_np)

REPO = pathlib.Path(__file__).resolve().parents[1]
N, B, WAVE, CONST = 31, 6, 2.0, 20.0


@pytest.mark.parametrize("fidelity", ["corrected", "as-shipped"])
@pytest.mark.parametrize("problem", ["c1_f1", "c1_f2", "c2_f1", "c2_f2"])
def test_assembly_fields_match_jax(problem, fidelity):
    """Every Stencil5 field of A, the H_m family and H_F, the velocity and
    the forcing agree to rtol 1e-12 (relative to the field's largest entry:
    the Gaussians underflow to denormals far from the source, where two
    exp implementations need not agree to 12 digits)."""
    cfg, jprob, jhm, tprob, thm = both_problems(N, B, WAVE, CONST, problem,
                                                fidelity)
    assert_stencils_close(tprob.A, jprob.A, 1e-12, "A")
    assert_stencils_close(thm, jhm, 1e-12, "hm")
    for full in (True, False):
        assert_stencils_close(
            tstencil.extract_hf_stencil(tprob.A, B, full_coupling=full),
            jstencil.extract_hf_stencil(jprob.A, B, full_coupling=full),
            1e-12, f"HF full={full}")
    # the standalone H_F assembly gives the same matrix as the slice of A
    hf_alone = tstencil.build_hf_stencil(
        N, B, CONST, cfg.eta, cfg.omega, cfg.h, tprob.c_full,
        fidelity=fidelity)
    assert_stencils_close(hf_alone,
                          jstencil.extract_hf_stencil(jprob.A, B), 1e-12,
                          "HF standalone")
    np.testing.assert_allclose(to_np(tprob.c_full), to_np(jprob.c_full),
                               rtol=1e-12)
    f_ref = to_np(jprob.f_grid)
    np.testing.assert_allclose(to_np(tprob.f_grid), f_ref, rtol=1e-12,
                               atol=1e-12 * np.abs(f_ref).max())
    assert tprob.f_vec.shape == (N * N,)


def test_stencil5_host_helpers_match_jax():
    _, jprob, _, tprob, _ = both_problems(N, B, WAVE, CONST)
    np.testing.assert_allclose(tprob.A.todense(), jprob.A.todense(),
                               rtol=1e-12, atol=1e-9)
    np.testing.assert_allclose(tprob.A.toscipy().toarray(),
                               tprob.A.todense(), rtol=0, atol=0)
    assert tprob.A.nnz == jprob.A.nnz == 5 * N * N - 4 * N
    assert tprob.A.shape == (N * N, N * N)
    assert tprob.A.grid_shape == (N, N)
    down, up = ht.interlayer_couplings(tprob.A)
    assert down is tprob.A.cs and up is tprob.A.cn


def test_config_matches_jax():
    for kw in (dict(), dict(n=63, b=12, wave_num=4.0, const=61.0, alpha=1.5)):
        jc, tc = hj.HelmholtzConfig(**kw), ht.HelmholtzConfig(**kw)
        assert (tc.h, tc.eta, tc.omega, tc.num_unknowns) == \
            (jc.h, jc.eta, jc.omega, jc.num_unknowns)
    assert ht.SolverConfig() == ht.SolverConfig(
        **{f: getattr(hj.SolverConfig(), f)
           for f in ("method", "restart", "rtol", "maxiter",
                     "record_history")})
    # the chunk bound is the card's own (larger than the reference's)
    from helmholtz_tpu_torch.precond.sweeping import DEFAULT_SETUP_CHUNK
    assert ht.PrecondConfig().setup_chunk == DEFAULT_SETUP_CHUNK
    assert ht.PrecondConfig().kind == hj.PrecondConfig().kind
    assert set(ht.problems.PROBLEMS) == set(hj.problems.PROBLEMS)
    assert ht.problems.SMOOTH_VELOCITY == hj.problems.SMOOTH_VELOCITY
    assert (ht.problems.ROW_INVARIANT_VELOCITY
            == hj.problems.ROW_INVARIANT_VELOCITY)


def test_port_imports_without_jax():
    """`import helmholtz_tpu_torch` succeeds in a process where importing
    jax is blocked, and needs neither nvcc nor a card."""
    code = ("import sys; sys.modules['jax'] = None; "
            "import helmholtz_tpu_torch as ht; "
            "import helmholtz_tpu_torch.convert, "
            "helmholtz_tpu_torch.ops.kernels.build; "
            "assert 'helmholtz_tpu' not in sys.modules; "
            "print(ht.__version__)")
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ht.__version__


def test_port_sources_name_no_jax():
    files = sorted((REPO / "helmholtz_tpu_torch").rglob("*.py"))
    files.append(REPO / "chip_smoke.py")
    assert len(files) > 15
    for path in files:
        text = path.read_text()
        for needle in ("import jax", "from jax", "helmholtz_tpu ",
                       "helmholtz_tpu.", "import helmholtz_tpu\n"):
            assert needle not in text, (str(path), needle)


def test_default_device_raises_without_a_card():
    """Entry points default to the card and raise where there is none; they
    never carry on on the CPU by themselves."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works here")
    cfg = ht.HelmholtzConfig(n=15, b=4, wave_num=1.0, const=20.0)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.run_solver(15, 4, 1.0, 20.0)
    with pytest.raises(RuntimeError, match="cuda"):
        ht.assemble_problem(cfg)
    prob = ht.assemble_problem(cfg, device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        ht.gmres(lambda v: v, prob.f_vec)
    with pytest.raises(RuntimeError, match="cuda"):
        from helmholtz_tpu_torch.precond import setup_preconditioner
        setup_preconditioner(prob.A, prob.A, 4)
