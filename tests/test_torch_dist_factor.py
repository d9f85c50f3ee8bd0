"""The port's per-band setup against the JAX package's on the CPU, in
complex128.

The JAX side runs `distributed_setup(9)` on `make_mesh(4)`; the port runs
`dist.factor` on four gloo ranks (one spawn for the module,
`torch_dist_ranks.factor_cases`).  Held to 1e-10: each band's G panels
(row-aligned with zero F panels, lerp-expanded from strided samples, or the
band's sample window with its local tables), H_F's stack, the band's
operator rows and forcing.  `convert.dist_state_from_numpy` turns the JAX
global state into each rank's band state, which must equal the rank's own;
no rank holds more than its band; the assemble-only setups of the
amortized sweep give the full setups' operator and H_F."""
import jax.numpy as jnp
import numpy as np
import pytest

from helmholtz_tpu.dist import distributed_setup as j_setup
from helmholtz_tpu.dist import distributed_setup9 as j_setup9
from helmholtz_tpu.dist import make_mesh as j_make_mesh
from helmholtz_tpu_torch.dist import launch
from helmholtz_tpu_torch.dist.partition import band_sample_windows

import torch_dist_ranks

NDEV = 4
N, B = 32, 3
N_LOC = N // NDEV
CASES = (("dense", False, {}),
         ("strided", False, dict(factor_stride=3)),
         ("compressed", False, dict(factor_stride=3, g_compress=True)),
         ("nine", True, dict(factor_stride=3, g_compress=True)))
NAMES = [c[0] for c in CASES]


def _np(x):
    return np.asarray(jnp.asarray(x, jnp.float32)
                      if x.dtype == jnp.bfloat16 else x)


@pytest.fixture(scope="module")
def sides():
    mesh = j_make_mesh(NDEV)
    jax_out, states = {}, {}
    for name, nine, kw in CASES:
        fn = j_setup9 if nine else j_setup
        A, S, f = fn(mesh, N, B, 2.0, 20.0, 2.0, "c1_f1", pad_lanes=False,
                     **kw)
        jax_out[name] = (A, S, f)
        st = dict(nine=nine, g_dtype=None, G_re=_np(S.G_pad.re),
                  G_im=_np(S.G_pad.im), b=S.b, d2_replace=S.d2_replace, n=N,
                  TF=_np(S.TF.re) + 1j * _np(S.TF.im))
        fields = ("hf_l", "hf_u", "a_l", "a_u") if nine else \
            ("hf_cs", "hf_cn", "a_cs", "a_cn")
        st.update({k: getattr(S, k).to_np() for k in fields})
        if S.g_stride:
            st.update(g_w=np.asarray(S.g_w), g_lo=np.asarray(S.g_lo),
                      g_stride=S.g_stride)
        states[name] = st
    ranks = launch.run_ranks(torch_dist_ranks.factor_cases, NDEV,
                             device="cpu", cases=CASES, jax_states=states,
                             n=N, b=B)
    return jax_out, ranks


def _close(got, ref, tol, what):
    ref = np.asarray(ref)
    np.testing.assert_allclose(got, ref, rtol=tol,
                               atol=tol * max(np.abs(ref).max(), 1e-300),
                               err_msg=what)


@pytest.mark.parametrize("name", NAMES)
def test_band_setup_matches_jax(sides, name):
    jax_out, ranks = sides
    A, S, f = jax_out[name]
    got = ranks[name]
    _close(got["G_re"], S.G_pad.re, 1e-10, "G re")
    _close(got["G_im"], S.G_pad.im, 1e-10, "G im")
    _close(got["TF"], S.TF.to_np(), 1e-10, "TF")
    _close(got["f"], f.to_np(), 1e-12, "f")
    for a, fld in zip(got["A"], A.fields() if hasattr(A, "fields")
                      else [getattr(A, k) for k in A.__dataclass_fields__]):
        _close(a, fld.to_np(), 1e-12, "A")
    nine = dict((c[0], c[1]) for c in CASES)[name]
    coup = (S.a_l, S.a_u) if nine else (S.a_cs, S.a_cn)
    for a, c in zip(got["couplings"], coup):
        _close(a, c.to_np(), 1e-12, "couplings")
    if S.g_stride:
        np.testing.assert_array_equal(got["tables"][1], np.asarray(S.g_lo))
        np.testing.assert_allclose(got["tables"][0], np.asarray(S.g_w),
                                   rtol=0, atol=1e-7)
    else:
        assert got["tables"] is None
        np.testing.assert_array_equal(got["G_re"][:B], 0)   # F rows


@pytest.mark.parametrize("name", NAMES)
def test_convert_band_state_matches_setup(sides, name):
    """`convert.dist_state_from_numpy` of the JAX global state is, on
    every rank, the band state the rank factored itself."""
    _, ranks = sides
    for diff in ranks[name]["convert_diff"]:
        for k, d in diff.items():
            tol = 1e-7 if k == "g_w" else 0 if k == "g_lo" else 1e-10
            assert d <= tol, (k, d)


@pytest.mark.parametrize("name", NAMES)
def test_no_rank_holds_more_than_its_band(sides, name):
    """Dense bands hold n_loc panels, compressed bands their sample window
    (the widest band's length), and n_loc rows of couplings: no G stack
    exists whole anywhere."""
    _, ranks = sides
    kw = dict((c[0], c[2]) for c in CASES)[name]
    if kw.get("g_compress"):
        _, panels = band_sample_windows(N - B, kw["factor_stride"], B,
                                        N_LOC, NDEV)
        assert panels < N - B
    else:
        panels = N_LOC
    for g_re, g_im, coup in ranks[name]["held"]:
        assert g_re[0] == g_im[0] == panels
        assert coup[0] == N_LOC


@pytest.mark.parametrize("name", ("dense", "nine"))
def test_assemble_matches_setup(sides, name):
    """The assemble-only band setup (the amortized sweep's intermediate
    frequencies) gives the full setup's operator, forcing and H_F stack,
    and no G."""
    _, ranks = sides
    assert ranks[name]["assemble_same"] == [(True, 0)] * NDEV
