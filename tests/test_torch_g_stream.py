"""The sweep wrapper's count of the G bytes each K2 launch streams
(`ops.kernels.sweep.g_stream_bytes`, summed in `g_bytes_by_variant`)
against hand counts at the benchmark cells' shapes, and the benchmark's
reader of it (`portbench/metrics/apply.g_gib_per_apply.py`)."""
import importlib.util
import pathlib
import types

import pytest

from helmholtz_tpu_torch.ops.kernels import sweep as k2

GIB = 2 ** 30
READER = (pathlib.Path(__file__).resolve().parents[1] / "portbench"
          / "metrics" / "apply.g_gib_per_apply.py")


def apply_bytes(n, b, R, itemsize, *, lerp=False, shared=False):
    """G bytes of one apply: the forward sweep's M - 1 steps and the
    backward's M, each in the launches `launch_widths` makes."""
    M = n - b
    widths = k2.launch_widths(R, n, itemsize, lerp, shared, False,
                              k2.H100_SMS)
    return sum(len(widths) * k2.g_stream_bytes(n, S, itemsize, lerp=lerp,
                                               shared=shared)
               for S in (M - 1, M))


@pytest.mark.parametrize("n,steps,itemsize,lerp,shared,want", [
    # dense: one n x ld panel a step, two planes
    (1023, 1010, 2, False, False, 1010 * 1023 * 1024 * 2 * 2),
    (1023, 1011, 4, False, False, 1011 * 1023 * 1024 * 2 * 4),
    (2047, 2034, 2, False, False, 2034 * 2047 * 2048 * 2 * 2),
    # lerp tables: the two samples of a step's pair
    (2047, 2034, 2, True, False, 2034 * 2 * 2047 * 2048 * 2 * 2),
    (1023, 1011, 2, True, False, 1011 * 2 * 1023 * 1024 * 2 * 2),
    # one shared panel: once a launch, whatever the steps
    (2047, 2035, 2, False, True, 2047 * 2048 * 2 * 2),
    (1023, 1010, 4, False, True, 1023 * 1024 * 2 * 4),
])
def test_g_stream_bytes_by_hand(n, steps, itemsize, lerp, shared, want):
    assert k2.g_stream_bytes(n, steps, itemsize, lerp=lerp,
                             shared=shared) == want


def test_cells_g_bytes_an_apply():
    # c1_f1-n1023.gather64: dense bf16, the wide kernel, one launch a sweep
    assert k2.launch_widths(64, 1023, 2, False, False, False,
                            k2.H100_SMS) == (64,)
    dense = apply_bytes(1023, 12, 64, 2)
    assert dense == 2021 * 1023 * 1024 * 4
    assert round(dense / GIB, 2) == 7.89
    # c1_f1-n1023.sweep4: four sources, one narrow launch, the same bytes
    assert apply_bytes(1023, 12, 4, 2) == dense
    # c2_f1-n2047.gather16: one shared panel, four chunks a sweep
    shared = apply_bytes(2047, 12, 16, 2, shared=True)
    assert shared == 8 * 2047 * 2048 * 4
    assert round(shared / GIB, 3) == 0.125
    # c1_f1-n2047.gather16-y125: lerp, four chunks of four a sweep, each
    # step a 33.5 MB pair of bf16 samples
    lerp = apply_bytes(2047, 12, 16, 2, lerp=True)
    assert lerp == 4 * 4069 * 2 * 2047 * 2048 * 4
    assert round(2 * 2047 * 2048 * 4 / 1e6, 1) == 33.5
    assert round(lerp / GIB) == 508
    # the least: each of the 256 samples read once a sweep
    assert round(2 * 256 * 2047 * 2048 * 4 / GIB, 1) == 8.0
    # a batch that shrinks to three sources walks one chunk
    assert apply_bytes(2047, 12, 3, 2, lerp=True) == lerp // 4


def test_the_counter_is_keyed_like_the_launches_and_reset():
    k2.reset_counts()
    try:
        k2._count("fwd", 4, True, False, False, 100)
        k2._count("fwd", 4, True, False, False, 100)
        k2._count("bwd", 2, True, False, False, 7)
        assert k2.launches_by_variant == {("fwd", 4, True, False, False): 2,
                                          ("bwd", 2, True, False, False): 1}
        assert k2.g_bytes_by_variant == {("fwd", 4, True, False, False): 200,
                                         ("bwd", 2, True, False, False): 7}
    finally:
        k2.reset_counts()
    assert k2.g_bytes_by_variant == {} and k2.launches_by_variant == {}


def test_the_benchmark_reader_divides_by_the_applies(monkeypatch):
    spec = importlib.util.spec_from_file_location("g_gib_reader", READER)
    reader = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(reader)
    run = types.SimpleNamespace(trace=object(), applies=[1, 2, 3, 4])
    monkeypatch.setattr(k2, "g_bytes_by_variant",
                        {("fwd", 4, True, False, False): 6 * GIB,
                         ("bwd", 4, True, False, False): 2 * GIB})
    assert reader.read(run) == 2.0
    # nothing to read: no trace, no apply, no launch
    assert reader.read(types.SimpleNamespace(trace=None, applies=[1])) is None
    assert reader.read(types.SimpleNamespace(trace=object(),
                                             applies=[])) is None
    monkeypatch.setattr(k2, "g_bytes_by_variant", {})
    assert reader.read(run) is None
    # a program without the counter (the module raises AttributeError)
    monkeypatch.delattr(k2, "g_bytes_by_variant")
    assert reader.read(run) is None
