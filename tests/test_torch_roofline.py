"""Smoke test of the port's measured peaks (`bench.roofline`) on the CPU at
a few MB, after the JAX package's `tests/test_aux.py` smoke test of its
roofline measures: each returns a finite positive rate.  The numbers here
are the host's and say nothing of the card."""
import math

import pytest

from helmholtz_tpu_torch.bench import roofline

from torch_parity import single_thread  # noqa: F401


@pytest.mark.parametrize("measure, size", [("measure_streaming_bw", 4),
                                           ("measure_read_bw", 4),
                                           ("measure_matmul_tflops", 128)])
def test_roofline_measures_smoke(measure, size):
    rate = getattr(roofline, measure)(size, iters=3, device="cpu")
    assert math.isfinite(rate) and rate > 0
