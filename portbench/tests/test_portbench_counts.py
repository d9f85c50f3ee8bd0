"""The frozen work counts against the program's own roofline arithmetic
(`helmholtz_tpu_torch/bench/roofline.py`) and hand counts at the cells'
shapes."""
import math

import pytest

from counts import roofline as rl
from helmholtz_tpu_torch.bench import roofline as port_rl
from helmholtz_tpu_torch.ops.kernels.sweep import g_ld


def test_peaks_are_the_programs():
    assert rl.PUBLISHED_BYTES_PER_S == port_rl.PUBLISHED_BYTES_PER_S
    assert rl.PUBLISHED_F32_FLOPS == port_rl.PUBLISHED_F32_FLOPS


def test_gj_count_is_the_programs_gj_model():
    n, b = 47, 6
    r = port_rl.measure_setup(n, b, factor_stride=4, g_dtype="f32",
                              peaks={"read_gb_s": 1.0, "stream_gb_s": 1.0,
                                     "matmul_tflops": 1.0}, device="cpu")
    _, flops = rl.gj_work(r["samples"] * b, n)
    assert math.isclose(flops / 1e12, r["factor_gj_tflop"], rel_tol=1e-12)


@pytest.mark.parametrize("n,itemsize", [(1023, 2), (2047, 2), (1023, 4)])
def test_dense_sweep_bytes_against_the_programs_g_traffic(n, itemsize):
    """bench/roofline.measure_sweep counts 2 M panels of n x ld an apply;
    the frozen count reads the (M - 1) + M panels the two sweeps use, of
    n x n, once each."""
    M = n - 12
    port_gb = 2 * 2 * M * n * g_ld(n) * itemsize / 1e9
    g = 0.0
    for steps in (M - 1, M):
        b_, _ = rl.sweep_work(n, steps, 1, g_itemsize=itemsize, planes=M)
        g += b_ - ((2 + 1) * steps + 1) * n * 8
    assert math.isclose(g / 1e9, port_gb * (2 * M - 1) / (2 * M)
                        * n / g_ld(n), rel_tol=1e-12)


def test_cell_shapes_by_hand():
    # c1_f1-n1023.gather64: one apply of all 64 sources over the dense bf16
    # stack is bound by its operations: 8 n^2 a source a step
    n, M, K = 1023, 1011, 64
    least = sum(rl.least_seconds(*rl.sweep_work(
        n, s, K, g_itemsize=2, planes=M)) for s in (M - 1, M))
    assert math.isclose(least, (2 * M - 1) * 8 * n * n * K / 67e12,
                        rel_tol=1e-12)
    assert 0.0160 < least < 0.0163
    # one source: bound by the bytes, G read once a sweep
    one = sum(rl.least_seconds(*rl.sweep_work(
        n, s, 1, g_itemsize=2, planes=M)) for s in (M - 1, M))
    assert 2.5e-3 < one < 2.6e-3
    # c2_f1-n2047: one shared panel, so the operations bound every width
    n, M = 2047, 2035
    b_, f = rl.sweep_work(n, M, 1, g_itemsize=2, planes=1, shared=True)
    assert f == 8 * n * n * M and f / 67e12 > b_ / 3.35e12
    # K3 on (146, 64, 64): 146 (8 k^3 + 8 k^2) operations, 16 k^2 bytes each
    assert rl.gj_work(146, 64) == (16.0 * 64 * 64 * 146,
                                   146 * (8 * 64 ** 3 + 8 * 64 ** 2))


def test_lerp_sweep_reads_each_sample_once():
    n, S, Ms = 1023, 1010, 145
    b_, f = rl.sweep_work(n, S, 4, g_itemsize=2, planes=Ms, lerp=True)
    assert b_ == Ms * n * n * 4 + ((2 * 4 + 1) * S + 4) * n * 8 + 12 * S
    assert f == (8 * 4 + 6) * n * n * S
