"""The port's discretization-accuracy study
(`helmholtz_tpu_torch.bench.accuracy`) against the JAX package's: the
closed-form manufactured forcing against JAX's nested autodiff, one
accuracy point per stencil through both pipelines on the CPU in complex128,
and the convergence orders of fixed rows."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from helmholtz_tpu.bench import accuracy as jacc
from helmholtz_tpu_torch.bench import accuracy as tacc


@pytest.mark.parametrize("wave_num", (4.0, 16.0))
def test_manufactured_fields_match_jax_autodiff(wave_num):
    omega = 2 * np.pi * wave_num + 2j
    xs = np.arange(1, 34) / 34.0
    X1, X2 = np.meshgrid(xs, xs, indexing="xy")
    ju, jf = jacc.manufactured_fields(omega)
    tu, tf = tacc.manufactured_fields(omega)
    tx = (torch.from_numpy(X1), torch.from_numpy(X2))
    jx = (jnp.asarray(X1), jnp.asarray(X2))
    for t_fn, j_fn in ((tu, ju), (tf, jf)):
        got = t_fn(*tx).numpy()
        ref = np.asarray(j_fn(*jx))
        assert got.dtype == np.complex128
        assert np.abs(got - ref).max() <= 1e-12 * np.abs(ref).max()


@pytest.mark.parametrize("stencil", ("5pt", "9pt"))
def test_measure_error_matches_jax(stencil):
    kw = dict(rtol=1e-10, maxiter=100)
    ref = jacc.measure_error(31, 3.0, stencil, **kw)
    got = tacc.measure_error(31, 3.0, stencil, device="cpu", **kw)
    assert got["iterations"] == ref["iterations"]
    assert got["converged"] and ref["converged"]
    assert abs(got["err_rel_interior"] / ref["err_rel_interior"] - 1) < 1e-8
    for key in ("stencil", "n", "b", "wave_num", "ppw", "const", "gamma",
                "precision", "dtype", "algebraic_rtol", "sigma"):
        assert got[key] == ref[key], key


def test_convergence_orders_match_jax():
    rows = [{"study": "refine", "stencil": s, "n": n, "err_rel_interior": e}
            for s, pts in (("5pt", ((63, 4.1e-2), (127, 9.7e-3),
                                    (255, 2.4e-3))),
                           ("9pt", ((63, 4.9e-4), (127, 2.9e-5),
                                    (255, 4.2e-6))))
            for n, e in pts]
    rows.append({"study": "ppw", "stencil": "5pt", "n": 255,
                 "err_rel_interior": 1.0})
    got = tacc.convergence_orders(rows)
    assert got == jacc.convergence_orders(rows)
    assert 1.9 < got["5pt"][0] < 2.2 and got["9pt"][0] > 3.9


def test_measure_error_needs_the_card_by_default():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cuda'"):
        tacc.measure_error(15, 1.0)
