"""CPU parity of the port's last JAX functions and of the reference's other
problems against the JAX package, in complex128: the stencil algebra, the
deviation-D1 emulation `apply_fixed_rhs`, the oracle script of the three
other problems, and a six-source `run_multisolve` on c1_f2."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from helmholtz_tpu import driver as jdriver
from helmholtz_tpu.ops import sparse_algebra as jalg
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu_torch import driver as tdriver
from helmholtz_tpu_torch import precond as tprecond
from helmholtz_tpu_torch.ops import sparse_algebra as talg
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.scripts import oracle_problems

from torch_parity import (FIELDS, port_problems, random_grid,  # noqa: F401
                          stencil_to_torch, to_jax, to_np)


def _random_stencil(seed, shape=(7, 9)):
    """A JAX Stencil5 of seeded complex fields, and the port's copy."""
    from helmholtz_tpu.core.sparse import Stencil5

    j = Stencil5(*(jnp.asarray(random_grid(seed + k, shape))
                   for k in range(len(FIELDS))))
    return j, stencil_to_torch(j)


@pytest.mark.parametrize("op", ["add", "scale", "axpy", "diag_update"])
def test_stencil_algebra_matches_jax(op):
    """Each stencil function on the same seeded fields as JAX's, to 1e-12;
    complex scalars, and a grid-shaped diagonal for the update."""
    A_j, A_t = _random_stencil(0)
    B_j, B_t = _random_stencil(10)
    alpha = 0.7 - 1.3j
    d = random_grid(20, (7, 9))
    got, ref = {
        "add": lambda: (talg.stencil_add(A_t, B_t),
                        jalg.stencil_add(A_j, B_j)),
        "scale": lambda: (talg.stencil_scale(A_t, alpha),
                          jalg.stencil_scale(A_j, alpha)),
        "axpy": lambda: (talg.stencil_axpy(alpha, A_t, B_t),
                         jalg.stencil_axpy(alpha, A_j, B_j)),
        "diag_update": lambda: (
            talg.stencil_diag_update(A_t, torch.from_numpy(d)),
            jalg.stencil_diag_update(A_j, jnp.asarray(d))),
    }[op]()
    for name in FIELDS:
        r = to_np(getattr(ref, name))
        np.testing.assert_allclose(to_np(getattr(got, name)), r, rtol=1e-12,
                                   atol=1e-12 * np.abs(r).max())


def test_apply_fixed_rhs_matches_jax():
    """Deviation D1 at n = 31 under the as-shipped fidelity: the callable
    ignores its argument, M(z) == M(f) exactly, and both equal JAX's
    `apply_fixed_rhs` to 1e-10 of the largest entry."""
    n, b = 31, 5
    _, jprob, jhm, tprob, thm = port_problems(n, b, 2.0, 20.0,
                                              fidelity="as-shipped")
    P_j = jsweep.setup_preconditioner(jprob.A, jhm, b, pad_lanes=False)
    P_t = tsweep.setup_preconditioner(tprob.A, thm, b, device="cpu")
    f = tprob.f_grid.reshape(-1)
    M_t = tprecond.apply_fixed_rhs(P_t, f)
    M_j = jsweep.apply_fixed_rhs(P_j, to_jax(f))
    z = torch.from_numpy(random_grid(3, (n * n,)))
    out_z, out_f = to_np(M_t(z)), to_np(M_t(f))
    np.testing.assert_array_equal(out_z, out_f)
    ref = np.asarray(M_j(to_jax(z)))
    np.testing.assert_allclose(out_z, ref, rtol=1e-10,
                               atol=1e-10 * np.abs(ref).max())
    # and the fixed output is the true sweep of f
    np.testing.assert_allclose(
        out_f, to_np(tsweep.apply_preconditioner(P_t, tprob.f_grid)
                     ).reshape(-1), rtol=1e-12)


def test_oracle_problems_matches_jax_count(tmp_path):
    """The oracle script at n = 31 for c2_f2 (omega/2pi = 4, C = 81), by
    the scipy oracle and by the port's own CPU solve: the rows' keys, and
    their counts equal the JAX package's complex128 `run_solver` counts at
    both tolerances; `main` writes the rows once and skips them when run
    again."""
    import json

    out = tmp_path / "rows.jsonl"
    argv = ["--problems", "c2_f2", "--ns", "31", "--out", str(out)]
    for impl in ("scipy", "port"):
        assert oracle_problems.main(argv + ["--impl", impl]) == 0
    assert oracle_problems.main(argv) == 0
    rows = [json.loads(line) for line in out.read_text().splitlines()]
    assert [r["metric"] for r in rows] == [
        f"{kind}_iters_c2_f2_n31_rtol{rtol}" for kind in ("oracle", "port")
        for rtol in ("0.001", "1e-06")]
    counts = {rtol: jdriver.run_solver(31, 12, 4.0, 81.0, problem="c2_f2",
                                       rtol=rtol).iterations
              for rtol in (1e-3, 1e-6)}
    for row in rows:
        assert row["problem"] == "c2_f2" and row["info"] == 0
        assert (row["n"], row["b"], row["wave_num"], row["const"]) == \
            (31, 12, 4.0, 81.0)
        for key in ("iters", "true_residual", "setup_s", "solve_s", "host",
                    "dtype", "impl"):
            assert key in row
        assert row["iters"] == counts[row["rtol"]]
        assert row["true_residual"] < row["rtol"]


def test_run_multisolve_six_sources_c1_f2_matches_jax(monkeypatch):
    """`run_multisolve(31, 5, [2.0], n_sources=6)` on c1_f2 in both
    packages: equal counts and true residuals, and the batched solve's x
    (read from each package's batched-solve stage inside the call) to 1e-8
    of its largest entry."""
    seen = {}

    def keep(module, key):
        inner = module._msolve_stage

        def stage(*args, **kw):
            seen[key] = res = inner(*args, **kw)
            return res
        monkeypatch.setattr(module, "_msolve_stage", stage)

    keep(jdriver, "jax")
    keep(tdriver, "port")
    args = (31, 5, [2.0])
    kw = dict(consts=[20.0], problem="c1_f2", n_sources=6, rtol=1e-3,
              maxiter=60)
    [r_j] = jdriver.run_multisolve(*args, **kw)
    [r_t] = tdriver.run_multisolve(*args, device="cpu", **kw)
    assert r_t["iterations"] == r_j["iterations"]
    assert len(r_t["iterations"]) == 6 and all(r_t["converged"])
    np.testing.assert_allclose(r_t["true_residuals"], r_j["true_residuals"],
                               rtol=1e-5)
    x_j = seen["jax"].x.to_np()
    np.testing.assert_allclose(to_np(seen["port"].x), x_j, rtol=1e-8,
                               atol=1e-8 * np.abs(x_j).max())
