"""The yardstick of the kernel metrics: the H100's published peaks and the
least work of the sweep kernel (K2) and the Gauss-Jordan kernel (K3),
counted from shapes.

Frozen copies, so that a change to the program cannot move them: the sweep
count is `chip_smoke.py`'s (every input read once, the output written once;
of G the panels the sweep uses, each once; 8 real operations a complex
multiply-add, and the two panels of a lerp step combined once), the
Gauss-Jordan count is `helmholtz_tpu_torch/bench/roofline.py`'s `_gj` model
(8 k^3 + 8 k^2 real operations an inverse of a (k, k) complex matrix), with
16 k^2 bytes read and written.
"""
from __future__ import annotations

#: NVIDIA's data sheet, H100 SXM at 700 W: HBM3 rate, float32 outside the
#: tensor cores
PUBLISHED_BYTES_PER_S = 3.35e12
PUBLISHED_F32_FLOPS = 67e12


def least_seconds(bytes_moved: float, flops: float) -> float:
    """The larger of the bytes over the memory rate and the operations over
    the float32 rate."""
    return max(bytes_moved / PUBLISHED_BYTES_PER_S,
               flops / PUBLISHED_F32_FLOPS)


def sweep_work(n: int, steps: int, width: int, *, g_itemsize: int,
               planes: int, lerp: bool = False, shared: bool = False,
               tri: bool = False) -> tuple[float, float]:
    """(bytes, operations) of one sweep of `steps` steps over (n, n) complex
    panels held as two real planes of `g_itemsize` bytes, carrying `width`
    right-hand sides.  `planes` is the number of panels the stack holds
    (the samples of a compressed stack, which a lerp sweep reads each once);
    a shared panel is read once, a dense stack one panel a step."""
    panel_bytes = n * n * 2 * g_itemsize
    c_rows = 3 if tri else 1
    vec_bytes = ((2 * width + c_rows) * steps + width) * n * 8
    panels = planes if lerp else 1 if shared else steps
    table_bytes = 12 * steps if lerp else 0
    flops = ((8 * width + (6 if lerp else 0)) * n * n
             + (24 * width * n if tri else 0)) * steps
    return panels * panel_bytes + vec_bytes + table_bytes, float(flops)


def gj_work(batch: int, k: int) -> tuple[float, float]:
    """(bytes, operations) of the Gauss-Jordan inverses of a (batch, k, k)
    complex64 batch."""
    return 16.0 * k * k * batch, float(batch * (8 * k ** 3 + 8 * k ** 2))
