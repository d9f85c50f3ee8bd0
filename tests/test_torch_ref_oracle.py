"""The port's scipy complex128 oracle (`helmholtz_tpu_torch.bench.ref_oracle`)
reproduces the JAX package's records in ORACLE.json from the port's own
assembly on the CPU, with no JAX call."""
import json
import os

import numpy as np
import pytest
import torch

from helmholtz_tpu_torch.bench import ref_oracle
from helmholtz_tpu_torch.fd import stencil as tstencil
from helmholtz_tpu_torch.ops import spmv

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _oracle_record(metric):
    with open(os.path.join(ROOT, "ORACLE.json")) as fh:
        rows = [json.loads(line) for line in fh if line.strip()]
    return next(r for r in rows if r["metric"] == metric)


def test_run_oracle_n127_matches_record():
    ref = _oracle_record("oracle_iters_n127_rtol0.001")
    [rec] = ref_oracle.run_oracle(127, rtols=(1e-3,))
    assert rec["metric"] == ref["metric"]
    assert rec["iters"] == ref["iters"] == 2
    assert rec["info"] == 0
    assert abs(rec["true_residual"] / ref["true_residual"] - 1) < 0.01
    assert (rec["n"], rec["b"], rec["wave_num"], rec["const"]) == \
        (ref["n"], ref["b"], ref["wave_num"], ref["const"])


def test_run_oracle9_n63_matches_record():
    ref = _oracle_record("oracle9_iters_n63_rtol0.001")
    [rec] = ref_oracle.run_oracle9(63, rtols=(1e-3,))
    assert rec["iters"] == ref["iters"] == 4
    assert abs(rec["true_residual"] / ref["true_residual"] - 1) < 0.01
    assert rec["b"] == ref["b"] == 12 and rec["stencil"] == "9pt"


def test_main_emits_one_line_per_rtol(capsys):
    assert ref_oracle.main(["--n", "31", "--b", "8", "--wave-num", "2",
                            "--const", "30", "--rtols", "1e-3", "1e-6"]) == 0
    lines = [json.loads(l) for l in capsys.readouterr().out.splitlines()]
    assert [r["rtol"] for r in lines] == [1e-3, 1e-6]
    assert lines[0]["iters"] <= lines[1]["iters"]
    assert all(r["info"] == 0 and r["true_residual"] < r["rtol"]
               for r in lines)


@pytest.mark.parametrize("nine", (False, True))
def test_strip_matrices_equal_stencil_products(nine):
    """The scipy matrices the oracle solves with are the port's operators:
    A_sp @ u equals the stencil product of the same fields."""
    n, b = 17, 4
    omega, h, eta, c_full, _ = ref_oracle._cpu_problem(n, b, 2.0, 2.0,
                                                       "c1_f1")
    kw = dict(fidelity="corrected", complex_dtype=torch.complex128)
    if nine:
        A = tstencil.build_a_stencil9(n, b, 30.0, eta, omega, h, c_full,
                                      **kw)
        A_sp = ref_oracle._strip9_to_csc(A)
        product = spmv.stencil9_matvec_flat
    else:
        A = tstencil.build_a_stencil(n, b, 30.0, eta, omega, h, c_full, **kw)
        A_sp = ref_oracle._strip_to_csc(
            ref_oracle._fields(A, ref_oracle._FIELDS5))
        product = spmv.stencil_matvec_flat
    rng = np.random.default_rng(0)
    u = rng.standard_normal(n * n) + 1j * rng.standard_normal(n * n)
    got = A_sp @ u
    ref = product(A, torch.from_numpy(u)).numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-13,
                               atol=1e-13 * np.abs(ref).max())
