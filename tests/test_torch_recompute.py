"""CPU parity of the port's recompute preconditioner (`precond.recompute`)
in complex128: its apply against the port's stored apply (stride 1 and 2,
chunks that do and do not divide the sweep), against the JAX package's
`apply_recompute`, its batched apply against single applies, and the
`run_solver` / `run_multisolve` paths with their guards."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu.precond import recompute as jrecompute
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch.precond import recompute as trecompute
from helmholtz_tpu_torch.precond import sweeping as tsweep

from torch_parity import (port_problems, random_grid, to_jax,  # noqa: F401
                          to_np)

N, B, WAVE, CONST = 33, 6, 2.0, 20.0
M = N - B


@pytest.fixture(scope="module")
def problem():
    return port_problems(N, B, WAVE, CONST)


def _recompute(tprob, **kw):
    return trecompute.setup_recompute(N, B, WAVE, CONST, 2.0, tprob.c_full,
                                      A=tprob.A, **kw)


def _rel(got, ref):
    return ((got - ref).norm() / ref.norm()).item()


@pytest.mark.parametrize("d2_replace", [True, False])
@pytest.mark.parametrize("chunk", [7, M])
def test_apply_recompute_matches_stored(problem, d2_replace, chunk):
    """Every chunk re-factored inside the apply gives the stored stack's
    apply (the plain loop) within 1e-12: 27 sweep rows in chunks of 7 (a
    short last chunk in each sweep) or in one chunk."""
    _, _, _, tprob, thm = problem
    P = tsweep.setup_preconditioner(tprob.A, thm, B, d2_replace=d2_replace,
                                    device="cpu")
    R = _recompute(tprob, d2_replace=d2_replace, chunk=chunk)
    f = torch.from_numpy(random_grid(1, (N, N)))
    keep = f.clone()
    got = trecompute.apply_recompute(R, f)
    assert torch.equal(f, keep)
    assert _rel(got, tsweep.apply_preconditioner(P, f, impl="plain")) < 1e-12
    assert _rel(R(f.reshape(-1)).reshape(N, N), got) == 0.0


@pytest.mark.parametrize("stride, chunk", [(2, 5), (4, 7)])
def test_apply_recompute_strided_global_anchoring(problem, stride, chunk):
    """factor_stride > 1 with a chunk that does not divide the sweep: the
    chunk's samples are anchored at multiples of the stride from row 0, so
    the apply equals the stored strided apply (expanded samples) within
    1e-12, whatever the chunk."""
    _, _, _, tprob, thm = problem
    P = tsweep.setup_preconditioner(tprob.A, thm, B, factor_stride=stride,
                                    device="cpu")
    R = _recompute(tprob, chunk=chunk, factor_stride=stride)
    f = torch.from_numpy(random_grid(2, (N, N)))
    ref = tsweep.apply_preconditioner(P, f, impl="plain")
    assert _rel(trecompute.apply_recompute(R, f), ref) < 1e-12


def test_chunk_tables_are_the_stored_tables():
    """Each chunk's local tables name the same samples and weights as the
    stored compressed stack's global tables, at every alignment; every
    index lies inside the chunk's window."""
    for Mr, stride in ((27, 2), (27, 4), (1011, 7), (50, 7)):
        pos = tsweep.sample_positions(Mr, stride)
        g_w, g_lo = tsweep.compress_tables(Mr, stride)
        for c in (1, 5, 7, 128):
            for k0 in range(0, Mr - min(c, Mr) + 1, max(1, Mr // 13)):
                cc = min(c, Mr - k0)
                offs, lo, w = trecompute.chunk_tables(Mr, stride, k0, cc)
                assert 0 <= lo.min() and lo.max() <= len(offs) - 2
                k = k0 + np.arange(cc)
                np.testing.assert_array_equal(offs[lo], pos[g_lo[k]])
                np.testing.assert_array_equal(offs[lo + 1],
                                              pos[g_lo[k] + 1])
                np.testing.assert_allclose(w, g_w[k], atol=1e-7)


def test_apply_recompute_matches_jax(problem):
    """The port's apply against JAX `apply_recompute` on the same operator
    and velocity field, within 1e-12."""
    _, _, _, tprob, _ = problem
    R_j = jrecompute.setup_recompute(
        N, B, WAVE, CONST, 2.0, to_jax(tprob.c_full), A=to_jax(tprob.A),
        fidelity="corrected", chunk=7)
    f = random_grid(3, (N, N))
    apply_j = jax.jit(jrecompute.apply_recompute)
    ref = np.asarray(apply_j(R_j, jnp.asarray(f)))
    got = to_np(trecompute.apply_recompute(_recompute(tprob, chunk=7),
                                           torch.from_numpy(f)))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12


def test_apply_recompute_multi_matches_single(problem):
    """Three sources through one pass (each chunk re-factored once for the
    batch) against three single applies, stride 1 and 2."""
    _, _, _, tprob, _ = problem
    F = torch.from_numpy(random_grid(4, (3, N, N)))
    for stride in (1, 2):
        R = _recompute(tprob, chunk=5, factor_stride=stride)
        got = trecompute.apply_recompute_multi(R, F)
        for i in range(3):
            assert _rel(got[i], trecompute.apply_recompute(R, F[i])) < 1e-12
        flat = R.apply_multi(F.reshape(3, -1)).reshape(3, N, N)
        assert _rel(flat, got) == 0.0


def test_run_solver_recompute_matches_stored():
    """`run_solver(63, 12, 4.0, 61.0, precond="recompute")`: converged in at
    most 4 iterations, the stored path's count, as the JAX package's own
    test pins."""
    rec = tdriver.run_solver(63, 12, 4.0, 61.0, precond="recompute",
                             device="cpu")
    ref = tdriver.run_solver(63, 12, 4.0, 61.0, device="cpu")
    assert rec.converged and rec.iterations <= 4
    assert rec.iterations == ref.iterations
    np.testing.assert_allclose(rec.u, ref.u, rtol=1e-10,
                               atol=1e-10 * np.abs(ref.u).max())
    assert rec.config["precond"] == "recompute"


def test_multisolve_recompute_and_guards():
    """`run_multisolve(precond="recompute")` gives the stored path's counts
    per source and records without G accounting; the 9-point stencil (in
    `run_multisolve` and `run_solver`) and a mesh are refused."""
    kw = dict(consts=[20.0], n_sources=2, device="cpu")
    [rec] = ht.run_multisolve(31, 5, [2.0], precond="recompute", **kw)
    [ref] = ht.run_multisolve(31, 5, [2.0], **kw)
    assert rec["converged"] == [True, True]
    assert rec["iterations"] == ref["iterations"]
    assert rec["precond"] == "recompute" and "g_bytes_at_rest" not in rec
    with pytest.raises(ValueError, match="5-point-path feature"):
        ht.run_multisolve(31, 5, [2.0], precond="recompute", stencil="9pt",
                          **kw)
    with pytest.raises(ValueError, match="single-chip capacity path"):
        ht.run_multisolve(31, 5, [2.0], precond="recompute", mesh_devices=2,
                          **kw)
    with pytest.raises(ValueError, match="supports precond='moving_pml'"):
        ht.run_solver(31, 5, 2.0, 20.0, precond="recompute", stencil="9pt",
                      device="cpu")
