"""Sweep-recursion kernel wrapper of the moving-PML preconditioner.

Replaces the TPU kernel `_kernel` / `pallas_sweep` of the JAX package's
`ops/pallas/sweep.py`.  The CUDA source is `csrc/sweep.cu`.

    fwd      : out[k] = u[k] - c[k] * (G[k] @ prev)
    bwd      : out[j] = G[j] @ (u[j] - c[j] * next)         (corrected D2)
    bwd_sub  : out[j] = u[j] - G[j] @ (u[j] + c[j] * next)  (as-shipped D2)

Bound: bytes.  Each step streams one n x n complex panel of G (two real
planes, float32 or bfloat16) against a vector that depends on the step
before.  The kernel splits a panel's rows over the whole card (one warp per
row) and orders the steps by one launch per step on the current stream; the
C entry point loops over the steps, so one call here is one sweep.  That
design is bound by launches, not bytes, at n = 1023; see the source note.

Layout: the planes are (Mg, n, ld) with row pitch `g_ld(n)` elements and
zero pad columns, so every row starts 16-byte aligned.

Ported: modes fwd / bwd / bwd_sub, dense G and one shared panel (Mg == 1),
diagonal coupling, one right-hand side, float32 and bfloat16 G.  Still to be
ported: batched right-hand sides (R > 1), sample-compressed G (lerp) and
tridiagonal coupling; they raise NotImplementedError.

`plain_sweep` is the plain PyTorch version (the loop form).  The wrapper
takes it only for tensors on the CPU; on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from . import build

MODES = ("fwd", "bwd", "bwd_sub")

#: number of sweeps launched by `sweep` in this process, in all and by mode;
#: one sweep is one call of the C entry point, which enqueues S step kernels
launches = 0
launches_by_mode = {m: 0 for m in MODES}


def reset_counts() -> None:
    global launches
    launches = 0
    for m in MODES:
        launches_by_mode[m] = 0


def g_ld(n: int) -> int:
    """Row pitch (in elements) of the G planes: n rounded up to 8, so that a
    row of bfloat16 (and of float32) starts on a 16-byte boundary."""
    return -(-n // 8) * 8


def _check_args(G_re, G_im, u, c, carry0, mode):
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if u.ndim == 3 or carry0.ndim == 2:
        raise NotImplementedError(
            "batched right-hand sides (R > 1) are not ported yet")
    if c.ndim == 3:
        raise NotImplementedError(
            "tridiagonal (9-point) coupling is not ported yet")
    if u.ndim != 2 or c.shape != u.shape or carry0.shape != u.shape[1:]:
        raise ValueError(f"expected u, c of shape (S, n) and carry0 (n,), "
                         f"got {tuple(u.shape)}, {tuple(c.shape)}, "
                         f"{tuple(carry0.shape)}")
    S, n = u.shape
    if (G_re.ndim != 3 or G_re.shape != G_im.shape
            or G_re.shape[1:] != (n, g_ld(n))):
        raise ValueError(f"G planes must be (Mg, {n}, {g_ld(n)}), got "
                         f"{tuple(G_re.shape)} and {tuple(G_im.shape)}")
    Mg = G_re.shape[0]
    shared = Mg == 1 and S > 1
    if not shared and not (S <= Mg if mode == "fwd" else S == Mg):
        raise ValueError(f"{mode}: {S} steps do not fit a stack of {Mg}")
    return S, n, shared


def plain_sweep(G_re, G_im, u, c, carry0, *, mode: str) -> torch.Tensor:
    """The recursion as a Python loop of dense matvecs: the plain version of
    the kernel.  The stored planes (any float type) are widened to the
    vector's float type and multiplied at full precision."""
    S, n, shared = _check_args(G_re, G_im, u, c, carry0, mode)
    rd = u.real.dtype
    out = torch.empty_like(u)

    def g_matvec(k, v):
        k = 0 if shared else k
        gre = G_re[k, :, :n].to(rd)
        gim = G_im[k, :, :n].to(rd)
        V = torch.stack([v.real, v.imag], dim=-1)          # (n, 2)
        RV = gre @ V
        IV = gim @ V
        return torch.complex(RV[:, 0] - IV[:, 1], RV[:, 1] + IV[:, 0])

    other = carry0
    steps = range(S) if mode == "fwd" else range(S - 1, -1, -1)
    for k in steps:
        if mode == "fwd":
            new = u[k] - c[k] * g_matvec(k, other)
        elif mode == "bwd":
            new = g_matvec(k, u[k] - c[k] * other)
        else:
            new = u[k] - g_matvec(k, u[k] + c[k] * other)
        out[k] = new
        other = new
    return out


def check_kernel_args(G_re, G_im, u, c, carry0) -> None:
    """What the kernel takes beyond the shapes `_check_args` holds: float32
    or bfloat16 planes, complex64 vectors, all contiguous and on one
    device.  Raises otherwise."""
    if G_re.dtype not in (torch.float32, torch.bfloat16) \
            or G_im.dtype != G_re.dtype:
        raise TypeError(f"the sweep kernel takes float32 or bfloat16 G "
                        f"planes, got {G_re.dtype} and {G_im.dtype}")
    for name, t in (("u", u), ("c", c), ("carry0", carry0)):
        if t.dtype != torch.complex64:
            raise TypeError(f"the sweep kernel takes complex64 vectors, "
                            f"{name} is {t.dtype}")
    for name, t in (("G_re", G_re), ("G_im", G_im), ("u", u), ("c", c),
                    ("carry0", carry0)):
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def sweep(G_re, G_im, u, c, carry0, *, mode: str) -> torch.Tensor:
    """Run one sweep recursion over the G stack.

    G_re, G_im : (Mg, n, ld) real planes, ld = g_ld(n), pad columns zero.
                 Mg == 1 with S > 1 is the shared-G family: one panel used
                 at every step.
    u          : (S, n) complex per-step input rows.  fwd: S <= Mg steps
                 use G[0..S-1] in order (pass the FULL stack with S = Mg-1;
                 never slice-copy G).  bwd / bwd_sub: S == Mg, rows are
                 processed last to first; `c` must have its top row zeroed.
    c          : (S, n) complex diagonal inter-layer coupling rows.
    carry0     : (n,) complex initial carry (fwd: the row below; bwd: zeros).

    Returns the (S, n) updated rows in natural order.
    """
    global launches
    S, n, shared = _check_args(G_re, G_im, u, c, carry0, mode)
    if u.device.type != "cuda":
        return plain_sweep(G_re, G_im, u, c, carry0, mode=mode)
    check_kernel_args(G_re, G_im, u, c, carry0)
    out = torch.empty_like(u)
    ld = g_ld(n)
    lib = build.library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        status = lib.hh_sweep(
            MODES.index(mode), int(G_re.dtype == torch.bfloat16),
            G_re.data_ptr(), G_im.data_ptr(), 0 if shared else n * ld, ld,
            n, S, u.data_ptr(), c.data_ptr(), carry0.data_ptr(),
            out.data_ptr(), stream)
    build.check(status, f"sweep[{mode}]")
    launches += 1
    launches_by_mode[mode] += 1
    return out
