"""The port's capacity planner (`helmholtz_tpu_torch.bench.plan`) against
the JAX package's on the terms whose layout both share, and held to hand
counts of the port's own layout (G planes at pitch g_ld(n), complex64 TF)
at the flagship size n = 2047."""
import pytest

from helmholtz_tpu.bench import plan as jplan
from helmholtz_tpu_torch.bench import plan as tplan
from helmholtz_tpu_torch.ops.kernels.sweep import g_ld

NS = (1023, 2047, 3071)
DEVICES = (4, 8, 16)
# the JAX planner rounds its GB to 2 decimals, the port's to 3
GB_TOL = 0.0051


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("stride", (0, 8))
def test_plan_shared_terms_match_jax(n, stride):
    kw = dict(batch=4, g_dtype="bf16", g_compress_stride=stride)
    got, ref = tplan.plan(n, **kw), jplan.plan(n, **kw)
    assert got["g_blocks_stored"] == ref["g_blocks_stored"]
    for key in ("operator_gb", "krylov_gb"):
        assert abs(got[key] - ref[key]) < GB_TOL, (key, got[key], ref[key])


@pytest.mark.parametrize("n", NS)
def test_plan9_shared_terms_match_jax(n):
    got, ref = tplan.plan9(n, batch=4), jplan.plan9(n, batch=4)
    assert got["b"] == ref["b"]
    assert got["g_panels_stored"] == ref["g_panels_stored"]
    for key in ("operator_gb", "krylov_gb"):
        assert abs(got[key] - ref[key]) < GB_TOL, (key, got[key], ref[key])


@pytest.mark.parametrize("n", NS)
@pytest.mark.parametrize("devices", DEVICES)
def test_plan_distributed_matches_jax(n, devices):
    got = tplan.plan_distributed(n, devices=devices)
    ref = jplan.plan_distributed(n, devices=devices)
    for key in ("rows_per_device", "subgrids_factored_per_device",
                "setup_flop_fraction_vs_dense", "g_panels_per_device"):
        assert got[key] == ref[key], (key, got[key], ref[key])


def test_flagship_layout_hand_counts():
    """n = 2047, b = 12: the dense bf16 stack is 2 planes x 2035 x 2047 x
    2048 x 2 B = 34.12 GB; compressed at stride 8 it keeps (2034 // 8) + 2
    = 256 panels, 4.293 GB at the port's pitch 2048 of 2047 rows (the JAX
    package's 2048 x 2048 panels: 4.295 GB)."""
    n, b = 2047, 12
    assert g_ld(n) == 2048
    dense = tplan.plan(n, b, g_dtype="bf16", factor_stride=8)
    assert dense["g_blocks_stored"] == n - b
    assert dense["g_stack_gb"] == round(2 * 2035 * 2047 * 2048 * 2 / 1e9, 3)
    assert abs(dense["g_stack_gb"] - 34.12) < 0.01
    # the strided dense setup holds its 256 float32 samples while it expands
    assert dense["g_samples_gb"] == round(2 * 256 * 2047 * 2048 * 4 / 1e9, 3)
    comp = tplan.plan(n, b, g_dtype="bf16", g_compress_stride=8)
    assert comp["g_blocks_stored"] == 256
    assert comp["g_stack_gb"] == 4.293
    assert jplan.plan(n, b, g_dtype="bf16",
                      g_compress_stride=8)["g_stack_gb"] == 4.29
    # TF is complex64 (b, n, n) on the card
    assert comp["tf_stack_gb"] == round(12 * 2047 ** 2 * 8 / 1e9, 3)
    p9 = tplan.plan9(n)
    assert p9["b"] == 147
    assert p9["tf_stack_gb"] == round(147 * 2047 ** 2 * 8 / 1e9, 3)
    assert p9["g_panels_stored"] == (2047 - 147 - 1) // 8 + 2


def test_plan_peaks_order_and_fit():
    """The dense flagship is the largest path and still fits the 80 GB card;
    its peak is the lerp expansion (dense stack + float32 samples), the
    compressed one's the setup, the 9-point one's H_F's stack."""
    dense = tplan.plan(2047, g_dtype="bf16", factor_stride=8)
    comp = tplan.plan(2047, g_dtype="bf16", g_compress_stride=8)
    nine = tplan.plan9(2047, batch=4)
    assert dense["peak_gb"] == dense["phase_gb"]["expand"]
    assert comp["peak_gb"] == comp["phase_gb"]["setup"]
    assert nine["peak_gb"] == nine["phase_gb"]["hf"]
    assert 40 < dense["peak_gb"] < 0.92 * 80 and dense["fits_single_chip"]
    assert comp["peak_gb"] < dense["peak_gb"] / 3
    assert not tplan.plan(2047, g_dtype="bf16", factor_stride=8,
                          hbm_gb=40.0)["fits_single_chip"]


def test_plan_device_reads_the_card_or_raises():
    import torch

    if torch.cuda.is_available():
        assert tplan.plan(1023, device="cuda")["hbm_gb"] > 0
    else:
        with pytest.raises(RuntimeError, match="device='cuda'"):
            tplan.plan(1023, device="cuda")
    assert tplan.plan(1023, device="cpu")["hbm_gb"] == 80.0
