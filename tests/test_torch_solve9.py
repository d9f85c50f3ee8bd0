"""The port's 9-point entry points on the CPU in complex128: iteration
counts against the scipy oracle rows of ORACLE.json (no JAX needed), and one
`run_solver` and one amortized `run_multisolve` record against those of
`helmholtz_tpu.driver` at n = 33.  That module compiles its 9-point stages
for tens of seconds a call, so it is called exactly twice, in one module
fixture.
"""
import json
import pathlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmholtz_tpu import driver as jdriver
from helmholtz_tpu_torch import driver as tdriver

ORACLE = {}
for _line in (pathlib.Path(__file__).resolve().parents[1]
              / "ORACLE.json").read_text().splitlines():
    _row = json.loads(_line)
    if _row.get("metric", "").startswith("oracle9_"):
        ORACLE[_row["metric"]] = _row

SOLVE_ARGS = (33, 6, 2.0, 20.0)
AM_ARGS = (33, 6, [2.1, 2.0, 2.05])
AM_KW = dict(consts=[20.0], n_sources=2, factor_stride=4, g_compress=True,
             freq_anchor_every=2, stencil="9pt")


@pytest.fixture(scope="module")
def jax_runs():
    """The two calls of `helmholtz_tpu.driver`'s 9-point entry points."""
    rep = jdriver.run_solver(*SOLVE_ARGS, stencil="9pt", rtol=1e-6,
                             complex_dtype=jnp.complex128)
    recs = jdriver.run_multisolve(*AM_ARGS, complex_dtype=jnp.complex128,
                                  **AM_KW)
    return rep, recs


@pytest.mark.parametrize("metric", ["oracle9_iters_n63_rtol0.001",
                                    "oracle9_iters_n63_rtol1e-06",
                                    "oracle9_iters_n127_rtol0.001"])
def test_run_solver9_matches_the_oracle(metric):
    """Exact stride-1 factorization in complex128: the oracle's iteration
    count, and its true residual to 1e-6 (the same x to solver precision)."""
    row = ORACLE[metric]
    rep = tdriver.run_solver(row["n"], row["b"], row["wave_num"],
                             row["const"], stencil="9pt", rtol=row["rtol"],
                             stencil_gamma=row["stencil_gamma"], device="cpu")
    assert rep.converged and rep.iterations == row["iters"]
    np.testing.assert_allclose(rep.true_residual, row["true_residual"],
                               rtol=1e-6)
    assert rep.config["stencil"] == "9pt"
    assert rep.config["dtype"] == "complex128"
    assert rep.config["factor_stride"] == 1


def test_run_solver9_matches_jax_run_solver(jax_runs):
    """n = 33 at rtol 1e-6: equal counts and flags, the residual history to
    1e-8 and u to 1e-8 of its largest entry."""
    ref, _ = jax_runs
    got = tdriver.run_solver(*SOLVE_ARGS, stencil="9pt", rtol=1e-6,
                             device="cpu")
    assert (got.iterations, got.converged) == (ref.iterations, ref.converged)
    assert got.converged
    np.testing.assert_allclose(got.history, ref.history, rtol=1e-8,
                               atol=1e-8 * ref.history.max())
    np.testing.assert_allclose(got.u, ref.u, rtol=1e-8,
                               atol=1e-8 * np.abs(ref.u).max())
    np.testing.assert_allclose(got.true_residual, ref.true_residual,
                               rtol=1e-5)
    for key, val in ref.config.items():
        assert got.config[key] == val, key
    assert got.config["device"] == "cpu"


def test_run_multisolve9_amortized_matches_jax(jax_runs):
    """Three frequencies out of order, an anchor every second one: the
    caller's order, the middle frequency omega-lerped, JAX's counts, and
    true residuals (against the filtered right-hand sides) of equal size."""
    _, recs_j = jax_runs
    recs_t = tdriver.run_multisolve(*AM_ARGS, device="cpu", **AM_KW)
    assert [r["wave_num"] for r in recs_t] == AM_ARGS[2]
    assert [r["setup_mode"] for r in recs_t] == \
        [r["setup_mode"] for r in recs_j] == ["factor", "factor",
                                              "omega_lerp"]
    for r_j, r_t in zip(recs_j, recs_t):
        assert set(r_t) == set(r_j)
        for key in r_j:
            if key in ("init_time_s", "solve_time_s", "compiled",
                       "true_residuals", "g_bytes_at_rest",
                       "g_traffic_gb_per_apply"):
                continue
            assert r_t[key] == r_j[key], key
        np.testing.assert_allclose(r_t["true_residuals"],
                                   r_j["true_residuals"], rtol=1e-5)
        assert r_t["converged"] == [True, True]
        assert r_t["stencil"] == "9pt"
        assert r_t["g_bytes_at_rest"] == 2 * 8 * 33 * 40 * 8   # 8 samples


def test_run_multisolve9_direct_agrees_with_run_solver():
    """Dense and compressed stacks give the same counts, and the source at
    the default position solves like `run_solver`'s own right-hand side
    would: same operator, filtered forcing, converged."""
    kw = dict(consts=[20.0], n_sources=2, stencil="9pt", device="cpu")
    dense = tdriver.run_multisolve(33, 6, [2.0], factor_stride=4, **kw)
    packed = tdriver.run_multisolve(33, 6, [2.0], factor_stride=4,
                                    g_compress=True, **kw)
    [d], [p] = dense, packed
    assert d["converged"] == p["converged"] == [True, True]
    assert d["iterations"] == p["iterations"]
    assert all(r < 1e-3 for r in d["true_residuals"] + p["true_residuals"])
    assert p["g_bytes_at_rest"] < d["g_bytes_at_rest"]
    assert "setup_mode" not in d and d["stencil_gamma"] == 2.0 / 3.0


def test_run_solver9_sampled_setups_keep_the_count():
    """The sampled setups (expanded, compressed, bf16 storage) apply the
    same interpolated operator, so they share one count, at most one above
    the exact setup's on a grid this coarse (stride 4 of 27 sweep rows), and
    report what they did."""
    exact = tdriver.run_solver(*SOLVE_ARGS, stencil="9pt", device="cpu")
    counts = []
    for kw in (dict(factor_stride=4), dict(factor_stride=4, g_compress=True),
               dict(factor_stride=4, g_dtype="bf16")):
        rep = tdriver.run_solver(*SOLVE_ARGS, stencil="9pt", device="cpu",
                                 **kw)
        assert rep.converged, kw
        assert rep.config["g_compress"] == bool(kw.get("g_compress"))
        counts.append(rep.iterations)
    assert len(set(counts)) == 1
    assert exact.iterations <= counts[0] <= exact.iterations + 1
    # g_compress without a sampled layout is reported as not applied, as
    # the reference package reports it
    rep = tdriver.run_solver(*SOLVE_ARGS, stencil="9pt", g_compress=True,
                             device="cpu")
    assert rep.config["g_compress"] is False
    assert rep.iterations == exact.iterations


def test_run_solver9_precision_path_in_complex64():
    """complex64 in flight with bf16 G: refinement in complex128 (residual
    through the 9-point product on widened coefficients) and one refinement
    of the preconditioner reach rtol 1e-6, which the plain complex64 solve
    cannot certify."""
    kw = dict(stencil="9pt", rtol=1e-6, maxiter=60, g_dtype="bf16",
              complex_dtype=torch.complex64, device="cpu")
    rep = tdriver.run_solver(63, 12, 8.0, 60.0, precision="ir-df32",
                             precond_refine=1, **kw)
    assert rep.converged and rep.true_residual < 5e-6
    assert rep.iterations <= ORACLE["oracle9_iters_n63_rtol1e-06"]["iters"]


def test_run_solver9_unpreconditioned_solves_the_filtered_system():
    """precond="none": GMRES on the 9-point operator alone reaches the dense
    solution of A9 u = M f."""
    n, b, wn, C = 9, 3, 1.0, 20.0
    rep = tdriver.run_solver(n, b, wn, C, stencil="9pt", precond="none",
                             rtol=1e-10, restart=81, device="cpu")
    assert rep.converged
    A9, c_full, f = tdriver._assemble_a9_stage(
        wn, C, 2.0, 2.0 / 3.0, n=n, b=b, problem="c1_f1",
        fidelity="corrected", cdtype=torch.complex128, device="cpu")
    f9 = tdriver._mass_filter9_stage(f, wn, C, 2.0, n=n, b=b)
    u = np.linalg.solve(A9.todense(), f9.numpy().reshape(-1))
    np.testing.assert_allclose(rep.u.reshape(-1), u, rtol=1e-7,
                               atol=1e-7 * np.abs(u).max())


def test_thin_pml_guard_raises(monkeypatch):
    assert [tdriver.min_pml_width9(n) for n in (63, 511, 1023)] == \
        [jdriver.min_pml_width9(n) for n in (63, 511, 1023)] == [5, 37, 74]
    monkeypatch.delenv("HELMHOLTZ_TPU_9PT_ALLOW_THIN_PML", raising=False)
    with pytest.raises(ValueError, match="b >= ~n/14 = 37"):
        tdriver.run_solver(511, 12, 64.0, 60.0, stencil="9pt", device="cpu")
    with pytest.raises(ValueError, match="b >= ~n/14 = 37"):
        tdriver.run_multisolve(511, 12, [64.0], stencil="9pt", device="cpu")
    tdriver._check_pml_width9(511, 37)
    monkeypatch.setenv("HELMHOLTZ_TPU_9PT_ALLOW_THIN_PML", "1")
    tdriver._check_pml_width9(511, 12)


def test_run_solver9_refuses_5_point_only_options():
    run = lambda **kw: tdriver.run_solver(15, 4, 1.0, 20.0, stencil="9pt",
                                          device="cpu", **kw)
    with pytest.raises(ValueError, match="dedup_hm"):
        run(dedup_hm=True)
    with pytest.raises(ValueError, match="hf_full_coupling"):
        run(hf_full_coupling=False)
    with pytest.raises(ValueError, match="stencil"):
        tdriver.run_solver(15, 4, 1.0, 20.0, stencil="7pt", device="cpu")
    with pytest.raises(RuntimeError, match="cuda"):
        tdriver.run_solver(15, 4, 1.0, 20.0, stencil="9pt")   # no card here
