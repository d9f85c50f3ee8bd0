"""Smoke tests of the port's roofline measures (`bench.roofline`) on the
CPU, after the JAX package's `tests/test_aux.py` smoke test of its
roofline: the peaks at a few MB each return a finite positive rate, and the
stencil product, setup phases and apply at n = 17 return the JAX
function's keys with finite values.  The numbers here are the host's and
say nothing of the card."""
import math

import pytest

from helmholtz_tpu_torch.bench import roofline


@pytest.mark.parametrize("measure, size", [("measure_streaming_bw", 4),
                                           ("measure_read_bw", 4),
                                           ("measure_matmul_tflops", 128)])
def test_roofline_measures_smoke(measure, size):
    rate = getattr(roofline, measure)(size, iters=3, device="cpu")
    assert math.isfinite(rate) and rate > 0


PEAKS = {"read_gb_s": 100.0, "stream_gb_s": 80.0, "matmul_tflops": 1.0}


def test_roofline_measure_sweep_smoke():
    r = roofline.measure_sweep(n=17, b=4, peaks=PEAKS, device="cpu")
    assert r["subgrids"] == 13
    assert r["s_per_apply"] > 0
    assert math.isfinite(r["effective_gb_per_s"])
    assert r["roofline_fraction_measured"] == pytest.approx(
        r["roofline_fraction"] * 3350.0 / 100.0)


def test_roofline_measure_spmv_and_setup_smoke():
    s = roofline.measure_spmv(17, iters=3, device="cpu")
    assert s["nnz"] == 5 * 17 * 17 - 4 * 17 and s["s_per_apply"] > 0
    for key in ("gnnz_per_s", "roofline_fraction",
                "roofline_fraction_measured", "peak_gb_s_full_model"):
        assert math.isfinite(s[key]) and s[key] > 0, key
    r = roofline.measure_setup(17, 4, factor_stride=3, peaks=PEAKS,
                               device="cpu")
    assert r["samples"] == 6 and r["factor_stride"] == 3
    for key in ("assembly_s", "factor_samples_s", "expand_s", "hf_s",
                "roofline_fraction", "expand_fraction_measured"):
        assert math.isfinite(r[key]) and r[key] > 0, key
    assert r["total_warm_s"] == pytest.approx(
        r["assembly_s"] + r["factor_samples_s"] + r["expand_s"] + r["hf_s"])
    # the own-count share is the JAX-model share at 8 n^3 + 8 n^2 flops an
    # inverse in place of 16 n^3 + 8 n^2
    own = (8 * 17 ** 3 + 8 * 17 ** 2) / (16 * 17 ** 3 + 8 * 17 ** 2)
    assert r["factor_gj_tflop"] == pytest.approx(
        r["factor_model_tflop"] * own)
    assert r["roofline_fraction_gj"] == pytest.approx(
        r["roofline_fraction"] * own)
