"""The sweep kernel's (K2) share of its roofline, %.

The least time of the sweeps of every apply in the traced window, each
sweep at the larger of its bytes over the published memory rate and its
operations over the published float32 rate (`counts.roofline.sweep_work`:
G read once a sweep for the whole batch, the right-hand sides and outputs
once, 8 operations a complex multiply-add), over K2's summed device time in
the trace.  The work is the same whatever carries it, so a batch split into
several launches shows as a lower share."""
from counts.roofline import least_seconds, sweep_work


def read(run):
    if run.trace is None:
        return None
    device_s = run.trace.kernel_seconds("sweep_kernel")
    if device_s <= 0 or not run.applies:
        return None
    least = 0.0
    for a in run.applies:
        for steps in ((a.rows - 1) if a.rows > 1 else 0, a.rows):
            if steps:
                least += least_seconds(*sweep_work(
                    a.n, steps, a.width, g_itemsize=a.g_itemsize,
                    planes=a.planes, lerp=a.lerp, shared=a.shared))
    return 100.0 * least / device_s
