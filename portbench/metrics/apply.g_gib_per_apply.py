"""Bytes of G the sweep kernel (K2) streamed an apply, GiB: the program's
counter `ops.kernels.sweep.g_bytes_by_variant` (each launch adds the panels
its plan reads once for the right-hand sides it carries: one a step, two
with lerp tables, one a launch over a shared panel), summed over the traced
window, over the window's applies.  None without a trace, an apply or the
counter (a program that has none, or a window that launched no sweep)."""
from helmholtz_tpu_torch.ops.kernels import sweep


def read(run):
    counter = getattr(sweep, "g_bytes_by_variant", None)
    if run.trace is None or not run.applies or not counter:
        return None
    return sum(counter.values()) / len(run.applies) / 2 ** 30
