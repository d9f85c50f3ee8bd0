"""The port's sample-compressed sweeping preconditioner against the plain
PyTorch reference of the benchmark (`portbench/torch_reference/
sweeping_torch.py`), on the CPU: its apply over float32 and bfloat16 G, the
reference's corner inverses against dense inverses, and GMRES through
`run_multisolve` held to the reference's true residual.

The reference imports nothing of the port and computes in complex128; the
port runs complex64 vectors, as on the card (here its plain sweep).
"""
import functools
import importlib.util
import math
import pathlib
import sys

import numpy as np
import pytest
import torch

from helmholtz_tpu_torch import driver
from helmholtz_tpu_torch.fd import problems as fd_problems
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.precond import sweeping

REF_PATH = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
            / "torch_reference" / "sweeping_torch.py")

B = 12
#: (omega / 2 pi, C) a grid size: the reference's sweep at n = 127; the
#: same points a wavelength at n = 63
PROBLEM = {63: (8.0, 61.0), 127: (16.0, 81.0)}

#: float32 G: complex64 products and carries over the ~100-250 steps of the
#: two sweeps, each rounding at ~6e-8, leave 2e-6 to 7e-6 of relative error
#: against complex128 (n = 63 to 255); 1e-4 leaves room for the sum
F32_TOL = 1e-4
#: bfloat16 G: the 8-bit mantissa of every stored element (unit roundoff
#: 2^-9) leaves 0.7e-2 to 1.1e-2 (n = 63 to 255); three times that
BF16_TOL = 3e-2
#: against the reference with its G stored in the same type: the port's
#: complex64 factor and sweeps, and the bf16 elements whose rounding the
#: complex64 factor tips over (1e-6 to 3e-5 here)
SAME_TOL = 1e-3


@functools.lru_cache(maxsize=None)
def reference():
    spec = importlib.util.spec_from_file_location("sweeping_torch", REF_PATH)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[spec.name] = mod
    spec.loader.exec_module(mod)
    return mod


def omega_of(n):
    return complex(2.0 * math.pi * PROBLEM[n][0], 2.0)


@functools.lru_cache(maxsize=None)
def reference_factor(n, stride):
    ref = reference()
    return ref.factor(n, B, PROBLEM[n][1], omega_of(n), "c1", stride=stride)


def port_stages(n, omega, const, cd=torch.complex64, b=B):
    h = 1.0 / (n + 1)
    c_full, _ = fd_problems.PROBLEMS["c1_f1"](omega, n, complex_dtype=cd,
                                              device="cpu")
    A = fd_stencil.build_a_stencil(n, b, const, b * h, omega, h, c_full,
                                   fidelity="corrected", complex_dtype=cd)
    hm = fd_stencil.build_hm_stencils(n, b, const, b * h, omega, h, c_full,
                                      fidelity="corrected", complex_dtype=cd)
    return A, hm


@functools.lru_cache(maxsize=None)
def port_factor(n, stride, g_dtype):
    A, hm = port_stages(n, omega_of(n), PROBLEM[n][1])
    return sweeping.setup_preconditioner(
        A, hm, B, g_dtype=g_dtype, factor_stride=stride, g_compress=True,
        device="cpu")


def random_rhs(k, n, seed):
    g = torch.Generator().manual_seed(seed)
    return torch.complex(torch.randn(k, n * n, generator=g, dtype=torch.float64),
                         torch.randn(k, n * n, generator=g, dtype=torch.float64))


def apply_errors(n, stride, g_dtype, R):
    X = random_rhs(R, n, 1000 * n + 10 * stride + R)
    Y = reference_factor(n, stride).apply(X.reshape(R, n, n)).reshape(R, -1)
    P = port_factor(n, stride, g_dtype)
    assert P.g_stride == stride and P.G_re.dtype == g_dtype
    Yp = P.apply_multi(X.to(torch.complex64)).to(torch.complex128)
    return ((Yp - Y).norm(dim=1) / Y.norm(dim=1)).tolist()


@pytest.mark.parametrize("R", [1, 4, 6])
@pytest.mark.parametrize("stride", [4, 8])
@pytest.mark.parametrize("n", [63, 127])
def test_compressed_apply_with_f32_g_matches_the_reference(n, stride, R):
    err = apply_errors(n, stride, torch.float32, R)
    assert max(err) < F32_TOL, err


@pytest.mark.parametrize("R", [1, 4, 6])
@pytest.mark.parametrize("stride", [4, 8])
@pytest.mark.parametrize("n", [63, 127])
def test_compressed_apply_with_bf16_g_is_told_apart(n, stride, R):
    """Within its own tolerance, and outside float32's: the comparison sees
    the storage precision."""
    err = apply_errors(n, stride, torch.bfloat16, R)
    assert max(err) < BF16_TOL, err
    assert min(err) > F32_TOL, err


@pytest.mark.parametrize("n", [63, 127])
def test_bf16_apply_is_the_reference_stored_in_bf16(n):
    """The port's whole bf16 error is the storage's: against the reference
    with G stored in bf16 it is complex64 arithmetic, while float32 G, and
    G stored in float8 (the type below), stay a storage error away."""
    ref = reference()
    R = 4
    X = random_rhs(R, n, 7 * n)
    stored = {name: ref.stored(reference_factor(n, 8), dtype).apply(
        X.reshape(R, n, n)).reshape(R, -1) for name, dtype in (
            ("bf16", torch.bfloat16), ("e4m3", torch.float8_e4m3fn))}

    def err(Y):
        return max(((Y - stored["bf16"]).norm(dim=1)
                    / stored["bf16"].norm(dim=1)).tolist())

    port = {g: port_factor(n, 8, g).apply_multi(X.to(torch.complex64)).to(
        torch.complex128) for g in (torch.bfloat16, torch.float32)}
    assert err(port[torch.bfloat16]) < SAME_TOL
    assert err(port[torch.float32]) > 5 * SAME_TOL
    assert err(stored["e4m3"]) > BF16_TOL


def test_sample_steps_and_interpolation_weights():
    ref = reference()
    assert ref.sample_steps(51, 8) == [0, 8, 16, 24, 32, 40, 48, 50]
    assert ref.sample_steps(49, 8) == [0, 8, 16, 24, 32, 40, 48]
    # the port's sample positions hold the same steps (with the endpoint
    # repeated where the stride divides it)
    for M, s in ((51, 8), (49, 8), (115, 4), (2035, 8)):
        assert sorted(set(sweeping.sample_positions(M, s).tolist())) == \
            ref.sample_steps(M, s)
    assert len(ref.sample_steps(2035, 8)) == 256
    # a step between samples applies the weighted pair
    G = torch.randn(3, 4, 4, dtype=torch.complex128)
    P = ref.Sweeping(n=4, b=1, A=None, TF=None, G=G, steps=[0, 4, 6])
    v = torch.randn(2, 4, dtype=torch.complex128)
    want = 0.25 * (v @ G[0].T) + 0.75 * (v @ G[1].T)
    assert torch.allclose(P.g(3, v), want, rtol=1e-14, atol=0)
    assert torch.equal(P.g(6, v), v @ G[2].T)


@pytest.mark.parametrize("b", [4, 12])
def test_stride_one_corner_inverses_are_the_dense_inverse_corner(b):
    """At n = 15 each subgrid's corner inverse is the top layer's block of
    the dense inverse of the subgrid's matrix, and the port's complex128
    Schur recursion gives the same; H_F's block Thomas is its dense solve."""
    ref = reference()
    n, const = 15, 20.0
    omega = complex(2.0 * math.pi * 2.0, 2.0)
    P = ref.factor(n, b, const, omega, "c1", stride=1)
    assert P.steps == list(range(n - b))
    fields = ref.subgrid_fields(n, b, const, omega, "c1", range(b, n))
    for k in range(n - b):
        H = ref.dense_matrix(tuple(f[k] for f in fields))
        want = torch.linalg.inv(H)[-n:, -n:]
        assert ((P.G[k] - want).abs().max() / want.abs().max()) < 1e-12
    _, hm = port_stages(n, omega, const, torch.complex128, b=b)
    G_re, G_im = sweeping.factor_corner_inverses(hm, g_dtype=torch.float64)
    port = torch.complex(G_re[:, :, :n], G_im[:, :, :n])
    assert ((port - P.G).abs().max() / P.G.abs().max()) < 1e-12
    band = tuple(f[:b].clone() for f in P.A)
    band[4][b - 1] = 0
    rhs = torch.randn(3, b, n, dtype=torch.complex128)
    want = torch.linalg.solve(ref.dense_matrix(band), rhs.reshape(3, -1).T).T
    got = P._thomas(rhs).reshape(3, -1)
    assert ((got - want).abs().max() / want.abs().max()) < 1e-12


def test_run_multisolve_over_compressed_g_meets_the_reference_residual(
        monkeypatch):
    """GMRES at rtol 1e-3 through `run_multisolve`, over bf16 G at stride 8
    in complex64 as the benchmark's configuration runs it: every solution's
    true residual, re-derived by the reference in complex128, is below the
    rtol and agrees with the record's own host residual."""
    ref = reference()
    n, k = 127, 4
    wave_num, const = PROBLEM[n]
    kept = []
    record = driver._multisolve_record

    def keep(key_cfg, A, P, res, F, **kw):
        kept.append((P, res.x.clone(), F.clone()))
        return record(key_cfg, A, P, res, F, **kw)

    monkeypatch.setattr(driver, "_multisolve_record", keep)
    (rec,) = driver.run_multisolve(
        n, B, [wave_num], consts=[const], n_sources=k, factor_stride=8,
        g_compress=True, g_dtype="bf16", complex_dtype=torch.complex64,
        rtol=1e-3, maxiter=60, device="cpu")
    (P, X, F), = kept
    assert P.g_stride == 8 and P.G_re.dtype == torch.bfloat16
    assert all(rec["converged"])
    omega = ref.omega_of(wave_num, 2.0)
    fields = ref.operator(n, B, const, omega, "c1")
    xs = np.linspace(0.2, 0.8, k).astype(np.float32)
    F_ref = torch.stack([ref.source_f1(n, omega, float(x), float(np.float32(
        0.125))) for x in xs])
    assert ((F_ref - F.reshape(k, n, n).to(torch.complex128)).abs().max()
            < 1e-6)
    res = ref.true_residuals(fields, X.reshape(k, n, n), F_ref)
    assert max(res) < 1e-3, res
    assert np.allclose(res, rec["true_residuals"], rtol=0.05, atol=0), (
        res, rec["true_residuals"])


@pytest.mark.parametrize("medium", ["c1", "c2"])
@pytest.mark.parametrize("n,b,const,wave_num", [(15, 12, 20.0, 2.0),
                                                (63, 12, 100.0, 7.5)])
def test_operator_and_source_are_the_numpy_references(medium, n, b, const,
                                                      wave_num):
    """The operator and the forcing are `portbench/reference/helmholtz.py`'s,
    which judges the cells, also where the PML layers overlap (n = 15)."""
    spec = importlib.util.spec_from_file_location(
        "portbench_reference_helmholtz", REF_PATH.parents[1] / "reference"
        / "helmholtz.py")
    nref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(nref)
    ref = reference()
    omega = ref.omega_of(wave_num, 2.0)
    for got, want in zip(ref.operator(n, b, const, omega, medium),
                         nref.coefficients(n, b, const, omega, medium)):
        assert np.abs(got.numpy() - want).max() <= 1e-13 * np.abs(want).max()
    assert np.abs(ref.source_f1(n, omega, 0.3, 0.125).numpy()
                  - nref.source_f1(n, omega, 0.3, 0.125)).max() <= 1e-14
