"""The Gauss-Jordan kernel's (K3) share of its roofline, %.

Each launch in the traced window inverts a (B, k, k) batch, B its grid's
blocks and k its template width (the kernel runs one block a matrix); its
least time is the larger of `counts.roofline.gj_work`'s bytes over the
published memory rate and operations over the published float32 rate.
Their sum over K3's summed device time."""
import re

from counts.roofline import gj_work, least_seconds

_K = re.compile(r"gj_inverse_kernel<(\d+)>")


def read(run):
    if run.trace is None:
        return None
    least, device_s = 0.0, 0.0
    for e in run.trace.events:
        m = _K.search(e.name)
        if e.cat != "kernel" or m is None or not e.grid:
            continue
        least += least_seconds(*gj_work(int(e.grid[0]), int(m.group(1))))
        device_s += (e.t1_ns - e.t0_ns) / 1e9
    return 100.0 * least / device_s if device_s > 0 else None
