"""Sweep-recursion kernel wrapper of the moving-PML preconditioner.

Replaces the TPU kernel `_kernel` / `pallas_sweep` of the JAX package's
`ops/pallas/sweep.py`.  The CUDA source is `csrc/sweep.cu`.

    fwd      : out[k] = u[k] - c[k] * (G[k] @ prev)
    bwd      : out[j] = G[j] @ (u[j] - c[j] * next)         (corrected D2)
    bwd_sub  : out[j] = u[j] - G[j] @ (u[j] + c[j] * next)  (as-shipped D2)

Bound: bytes.  Each step streams one n x n complex panel of G (two real
planes, float32 or bfloat16) against R vectors that depend on the step
before.  The kernel splits a panel's rows over the whole card (one warp per
row) and orders the steps by one launch per step on the current stream; the
C entry point loops over the steps, so one call here is one sweep.  That
design is bound by launches, not bytes, at n = 1023; see the source note.

Layout: the planes are (Mg, n, ld) with row pitch `g_ld(n)` elements and
zero pad columns, so every row starts 16-byte aligned.

Ported: modes fwd / bwd / bwd_sub; dense G, one shared panel (Mg == 1) and
sample-compressed G (lerp: `g_lo`, `g_w`); diagonal coupling; R >= 1
right-hand sides on one stream of G; float32 and bfloat16 G.  Still to be
ported: tridiagonal coupling, which raises NotImplementedError.

`plain_sweep` is the plain PyTorch version (the loop form).  The wrapper
takes it only for tensors on the CPU; on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import torch

from . import build

MODES = ("fwd", "bwd", "bwd_sub")

#: right-hand sides one launch of the kernel carries (its template widths
#: are 1..MAX_WIDTH); `sweep` walks a larger batch in chunks of this many
MAX_WIDTH = 4

#: the most dynamic shared memory a block gets on the card, in bytes
MAX_SHARED_BYTES = 232448

#: number of sweeps launched by `sweep` in this process, by (mode, number of
#: right-hand sides in the launch, with lerp tables).  One sweep is one call
#: of the C entry point, which enqueues S step kernels.  This is the one
#: count kept; `launches`, `launches_by_mode`, `launches_by_width` and
#: `launches_lerp` are read as attributes of the module and summed from it.
launches_by_variant: dict = {}


def reset_counts() -> None:
    launches_by_variant.clear()


def _count(mode: str, width: int, lerp: bool) -> None:
    key = (mode, width, lerp)
    launches_by_variant[key] = launches_by_variant.get(key, 0) + 1


def __getattr__(name: str):
    def total(keep):
        return sum(c for k, c in launches_by_variant.items() if keep(*k))

    if name == "launches":
        return total(lambda mode, width, lerp: True)
    if name == "launches_lerp":
        return total(lambda mode, width, lerp: lerp)
    if name == "launches_by_mode":
        return {m: total(lambda mode, width, lerp: mode == m) for m in MODES}
    if name == "launches_by_width":
        return {w: total(lambda mode, width, lerp: width == w)
                for w in range(1, MAX_WIDTH + 1)}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def g_ld(n: int) -> int:
    """Row pitch (in elements) of the G planes: n rounded up to 8, so that a
    row of bfloat16 (and of float32) starts on a 16-byte boundary."""
    return -(-n // 8) * 8


def _check_args(G_re, G_im, u, c, carry0, mode, g_lo, g_w):
    """Shapes of one sweep; returns (S, R, n, shared, lerp)."""
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if c.ndim == 3:
        raise NotImplementedError(
            "tridiagonal (9-point) coupling is not ported yet")
    if u.ndim not in (2, 3):
        raise ValueError(f"expected u of shape (S, n) or (S, R, n), got "
                         f"{tuple(u.shape)}")
    S, n = u.shape[0], u.shape[-1]
    R = u.shape[1] if u.ndim == 3 else 1
    if c.shape != (S, n) or carry0.shape != u.shape[1:] or R < 1:
        raise ValueError(f"expected u (S, n) with carry0 (n,), or u (S, R, n)"
                         f" with carry0 (R, n), and c (S, n); got "
                         f"{tuple(u.shape)}, {tuple(carry0.shape)}, "
                         f"{tuple(c.shape)}")
    if (G_re.ndim != 3 or G_re.shape != G_im.shape
            or G_re.shape[1:] != (n, g_ld(n))):
        raise ValueError(f"G planes must be (Mg, {n}, {g_ld(n)}), got "
                         f"{tuple(G_re.shape)} and {tuple(G_im.shape)}")
    Mg = G_re.shape[0]
    lerp = g_lo is not None
    if lerp != (g_w is not None):
        raise ValueError("pass both g_lo and g_w, or neither")
    if lerp:
        if (g_lo.ndim != 1 or g_lo.shape[0] < S or g_lo.dtype != torch.int32
                or g_w.shape != (g_lo.shape[0], 2)
                or g_w.dtype != torch.float32):
            raise ValueError(
                f"lerp tables must be g_lo (K,) int32 and g_w (K, 2) float32"
                f" with K >= {S} steps, got {tuple(g_lo.shape)} {g_lo.dtype}"
                f" and {tuple(g_w.shape)} {g_w.dtype}")
        if Mg < 2:
            raise ValueError("a sample stack needs at least 2 panels")
        return S, R, n, False, True
    shared = Mg == 1 and S > 1
    if not shared and not (S <= Mg if mode == "fwd" else S == Mg):
        raise ValueError(f"{mode}: {S} steps do not fit a stack of {Mg}")
    return S, R, n, shared, False


def plain_sweep(G_re, G_im, u, c, carry0, *, mode: str, g_lo=None,
                g_w=None) -> torch.Tensor:
    """The recursion as a Python loop of dense products: the plain version
    of the kernel, for the same arguments as `sweep`.  The stored planes
    (any float type) are widened to the vector's float type and multiplied
    at full precision; the float32 lerp weights are widened likewise and
    applied to the two panels' products, not to the panels."""
    S, R, n, shared, lerp = _check_args(G_re, G_im, u, c, carry0, mode,
                                        g_lo, g_w)
    rd = u.real.dtype
    batched = u.ndim == 3
    U = u if batched else u[:, None]
    out = torch.empty_like(U)
    if lerp:
        lo = g_lo[:S].tolist()
        w = g_w[:S].to(rd)

    def planes_dot(p, V):
        return G_re[p, :, :n].to(rd) @ V, G_im[p, :, :n].to(rd) @ V

    def g_matvec(k, v):
        V = torch.cat([v.real, v.imag]).T                  # (n, 2R)
        if lerp:
            RV0, IV0 = planes_dot(lo[k], V)
            RV1, IV1 = planes_dot(lo[k] + 1, V)
            RV = w[k, 0] * RV0 + w[k, 1] * RV1
            IV = w[k, 0] * IV0 + w[k, 1] * IV1
        else:
            RV, IV = planes_dot(0 if shared else k, V)
        return torch.complex(RV[:, :R] - IV[:, R:], RV[:, R:] + IV[:, :R]).T

    other = carry0 if batched else carry0[None]
    steps = range(S) if mode == "fwd" else range(S - 1, -1, -1)
    for k in steps:
        if mode == "fwd":
            new = U[k] - c[k] * g_matvec(k, other)
        elif mode == "bwd":
            new = g_matvec(k, U[k] - c[k] * other)
        else:
            new = U[k] - g_matvec(k, U[k] + c[k] * other)
        out[k] = new
        other = new
    return out if batched else out[:, 0]


def check_kernel_args(G_re, G_im, u, c, carry0, g_lo=None, g_w=None) -> None:
    """What the kernel takes beyond the shapes `_check_args` holds: float32
    or bfloat16 planes, complex64 vectors, all contiguous and on one
    device, and an operand that fits a block's shared memory.  Raises
    otherwise."""
    if G_re.dtype not in (torch.float32, torch.bfloat16) \
            or G_im.dtype != G_re.dtype:
        raise TypeError(f"the sweep kernel takes float32 or bfloat16 G "
                        f"planes, got {G_re.dtype} and {G_im.dtype}")
    for name, t in (("u", u), ("c", c), ("carry0", carry0)):
        if t.dtype != torch.complex64:
            raise TypeError(f"the sweep kernel takes complex64 vectors, "
                            f"{name} is {t.dtype}")
    tensors = [("G_re", G_re), ("G_im", G_im), ("u", u), ("c", c),
               ("carry0", carry0)]
    if g_lo is not None:
        tensors += [("g_lo", g_lo), ("g_w", g_w)]
    for name, t in tensors:
        if t.device != u.device:
            raise ValueError(f"{name} is on {t.device}, u on {u.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    width = min(u.shape[1] if u.ndim == 3 else 1, MAX_WIDTH)
    smem = 2 * width * G_re.shape[-1] * 4
    if smem > MAX_SHARED_BYTES:
        raise ValueError(
            f"{width} right-hand sides at row pitch {G_re.shape[-1]} need "
            f"{smem} bytes of shared memory, above the {MAX_SHARED_BYTES} a "
            "block gets; solve fewer right-hand sides at once")


def sweep(G_re, G_im, u, c, carry0, *, mode: str, g_lo=None,
          g_w=None) -> torch.Tensor:
    """Run one sweep recursion over the G stack.

    G_re, G_im : (Mg, n, ld) real planes, ld = g_ld(n), pad columns zero.
                 Mg == 1 with S > 1 (and no lerp tables) is the shared-G
                 family: one panel used at every step.
    u          : (S, n) complex per-step input rows, or (S, R, n) for R
                 right-hand sides that share the stream of G.  fwd: S <= Mg
                 steps use G[0..S-1] in order (pass the FULL stack with
                 S = Mg-1; never slice-copy G).  bwd / bwd_sub: S == Mg,
                 rows are processed last to first; `c` must have its top
                 row zeroed.
    c          : (S, n) complex diagonal inter-layer coupling rows, shared
                 by the right-hand sides.
    carry0     : (n,) or (R, n) complex initial carry (fwd: the row below;
                 bwd: zeros).
    g_lo, g_w  : sample-compressed G.  G holds SAMPLES of the stack and
                 logical step k applies
                     g_w[k, 0] * G[g_lo[k]] + g_w[k, 1] * G[g_lo[k] + 1];
                 g_lo is (K,) int32 with values <= Mg - 2, g_w (K, 2)
                 float32, K >= S.  The caller answers for the range of g_lo
                 (`SweepingPreconditioner` checks it once); zero weights
                 are allowed.

    One launch of the kernel carries at most MAX_WIDTH = 4 right-hand sides
    (32 KB of shared memory at ld = 1024).  A larger batch is walked in
    chunks of 4, each chunk a sweep of its own that streams G again; the
    launch counters count each chunk.

    Returns the (S, n) / (S, R, n) updated rows in natural order.
    """
    S, R, n, shared, lerp = _check_args(G_re, G_im, u, c, carry0, mode,
                                        g_lo, g_w)
    if u.device.type != "cuda":
        return plain_sweep(G_re, G_im, u, c, carry0, mode=mode, g_lo=g_lo,
                           g_w=g_w)
    check_kernel_args(G_re, G_im, u, c, carry0, g_lo, g_w)
    out = torch.empty_like(u)
    ld = g_ld(n)
    lib = build.library()
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, R, MAX_WIDTH):
            width = min(MAX_WIDTH, R - r0)
            skip = r0 * n * 8           # bytes to the chunk's first row
            status = lib.hh_sweep(
                MODES.index(mode), int(G_re.dtype == torch.bfloat16),
                G_re.data_ptr(), G_im.data_ptr(), 0 if shared else n * ld,
                ld, n, S, width, R * n,
                g_lo.data_ptr() if lerp else None,
                g_w.data_ptr() if lerp else None,
                u.data_ptr() + skip, c.data_ptr(), carry0.data_ptr() + skip,
                out.data_ptr() + skip, stream)
            build.check(status, f"sweep[{mode}]")
            _count(mode, width, lerp)
    return out
