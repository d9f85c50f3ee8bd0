"""Sweep-recursion kernel wrapper of the moving-PML preconditioner.

Replaces the TPU kernel `_kernel` / `pallas_sweep` of the JAX package's
`ops/pallas/sweep.py`.  The CUDA source is `csrc/sweep.cu`.

    fwd      : out[k] = u[k] - c[k] * (G[k] @ prev)
    bwd      : out[j] = G[j] @ (u[j] - c[j] * next)         (corrected D2)
    bwd_sub  : out[j] = u[j] - G[j] @ (u[j] + c[j] * next)  (as-shipped D2)

where c[k] is a diagonal (a row of n, the 5-point scheme's inter-layer
coupling) or a tridiagonal matrix (three rows [sub, diag, sup] of n, the
9-point scheme's).

Bound: bytes.  Each step streams one n x n complex panel of G (two real
planes, float32 or bfloat16) against R vectors that depend on the step
before.  One call here is one sweep and ONE cooperative launch: the steps
run inside a persistent kernel, one grid-wide barrier a step.  Each block
owns a fixed range of rows (`launch_plan`) and copies its rows of the next
step's panel into a ring of shared-memory stages before it waits at the
barrier, so the stream of G does not wait on the carry; see the source
note.

Layout: the planes are (Mg, n, ld) with row pitch `g_ld(n)` elements and
zero pad columns, so every row starts 16-byte aligned.

Ported: modes fwd / bwd / bwd_sub; dense G, one shared panel (Mg == 1) and
sample-compressed G (lerp: `g_lo`, `g_w`); diagonal and tridiagonal
coupling; R >= 1 right-hand sides on one stream of G; float32 and bfloat16
G.  That is every mode of the TPU kernel.

`plain_sweep` is the plain PyTorch version (the loop form).  The wrapper
takes it only for tensors on the CPU; on CUDA tensors it launches the kernel
or raises.
"""
from __future__ import annotations

import dataclasses
import functools

import torch

from . import build

MODES = ("fwd", "bwd", "bwd_sub")

#: right-hand sides one launch of the kernel carries (its template widths
#: are 1..MAX_WIDTH); `sweep` walks a larger batch in chunks of this many
MAX_WIDTH = 4

#: the most dynamic shared memory a block gets on the card, in bytes
MAX_SHARED_BYTES = 232448

#: the most stages of G the kernel's shared-memory ring holds
MAX_STAGES = 2

#: number of sweeps launched by `sweep` in this process, by (mode, number of
#: right-hand sides in the launch, with lerp tables, with tridiagonal
#: coupling, over one shared panel).  One sweep is one call of the C entry
#: point, which makes one cooperative launch of the persistent kernel.  This
#: is the one count kept; `launches`, `launches_by_mode`, `launches_by_width`,
#: `launches_lerp` and `launches_shared` are read as attributes of the module
#: and summed from it.
launches_by_variant: dict = {}

#: the `LaunchPlan` of the last launch of each variant, by the keys of
#: `launches_by_variant`: what the card ran, beside how often
plans_by_variant: dict = {}


def reset_counts() -> None:
    launches_by_variant.clear()
    plans_by_variant.clear()


def _count(mode: str, width: int, lerp: bool, tri: bool,
           shared: bool = False) -> None:
    key = (mode, width, lerp, tri, shared)
    launches_by_variant[key] = launches_by_variant.get(key, 0) + 1


def __getattr__(name: str):
    def total(keep):
        return sum(c for k, c in launches_by_variant.items() if keep(*k))

    if name == "launches":
        return total(lambda *key: True)
    if name == "launches_lerp":
        return total(lambda mode, width, lerp, tri, shared: lerp)
    if name == "launches_shared":
        return total(lambda mode, width, lerp, tri, shared: shared)
    if name == "launches_by_mode":
        return {m: total(lambda mode, *rest: mode == m) for m in MODES}
    if name == "launches_by_width":
        return {w: total(lambda mode, width, *rest: width == w)
                for w in range(1, MAX_WIDTH + 1)}
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def g_ld(n: int) -> int:
    """Row pitch (in elements) of the G planes: n rounded up to 8, so that a
    row of bfloat16 (and of float32) starts on a 16-byte boundary."""
    return -(-n // 8) * 8


@dataclasses.dataclass(frozen=True)
class LaunchPlan:
    """How one sweep is laid on the card: block b owns the rows
    [b * rows_per_block, (b + 1) * rows_per_block) of every step (the last
    block fewer), one warp a row at a time; `stages` stages of the block's
    rows of G fit in shared memory beside the operand (0: G is read from
    device memory directly); `shared_bytes` is the dynamic shared memory a
    block takes.  `csrc/sweep.cu` computes the same bytes from the same
    numbers."""
    blocks: int
    rows_per_block: int
    stages: int
    shared_bytes: int


@functools.lru_cache(maxsize=None)
def launch_plan(n: int, width: int, g_bytes: int, lerp: bool,
                shared: bool, sm_count: int) -> LaunchPlan:
    """The launch plan of a sweep of n rows with `width` right-hand sides
    over G of `g_bytes` bytes an element (2 or 4), two panels a step with
    `lerp`, one panel for the whole sweep with `shared`, on a card of
    `sm_count` SMs: at most one block per SM, so that every block is
    resident, and as many stages of G as fit (two, else one, else none; a
    shared panel is loaded once, into one stage)."""
    rows_per_block = -(-n // sm_count)
    blocks = -(-n // rows_per_block)
    ld = g_ld(n)
    operand = _operand_bytes(width, ld)
    stage = rows_per_block * (2 if lerp else 1) * 2 * ld * g_bytes
    stages = next(s for s in range(1 if shared else MAX_STAGES, -1, -1)
                  if operand + s * stage <= MAX_SHARED_BYTES)
    return LaunchPlan(blocks, rows_per_block, stages,
                      operand + stages * stage)


def _operand_bytes(width: int, ld: int) -> int:
    """Shared memory of the kernel's vector operand: `width` right-hand
    sides at row pitch ld, as float32 re and im planes.  Raises when it
    alone passes what a block gets."""
    operand = 2 * width * ld * 4
    if operand > MAX_SHARED_BYTES:
        raise ValueError(
            f"{width} right-hand sides at row pitch {ld} need {operand} bytes"
            f" of shared memory, above the {MAX_SHARED_BYTES} a block gets; "
            "solve fewer right-hand sides at once")
    return operand


@functools.lru_cache(maxsize=None)
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def _check_args(G_re, G_im, u, c, carry0, mode, g_lo, g_w):
    """Shapes of one sweep; returns (S, R, n, shared, lerp).  The coupling
    is tridiagonal exactly when c has rank 3."""
    if mode not in MODES:
        raise ValueError(f"unknown sweep mode {mode!r}")
    if u.ndim not in (2, 3):
        raise ValueError(f"expected u of shape (S, n) or (S, R, n), got "
                         f"{tuple(u.shape)}")
    S, n = u.shape[0], u.shape[-1]
    R = u.shape[1] if u.ndim == 3 else 1
    if (c.shape not in ((S, n), (S, 3, n)) or carry0.shape != u.shape[1:]
            or R < 1):
        raise ValueError(f"expected u (S, n) with carry0 (n,), or u (S, R, n)"
                         f" with carry0 (R, n), and c (S, n) or (S, 3, n); got "
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


def _panels_matvec(G_re, G_im, panels, v, w=None) -> torch.Tensor:
    """(R, n) rows v times the complex panel G[panels[0]], or with float
    weights w (2,) the lerp w[0] G[p0] + w[1] G[p1] applied as the weighted
    sum of the two panels' products.  The stored planes are widened to v's
    float type and multiplied at full precision."""
    R, n = v.shape
    rd = v.real.dtype
    V = torch.cat([v.real, v.imag]).T                      # (n, 2R)
    prods = [(G_re[p, :, :n].to(rd) @ V, G_im[p, :, :n].to(rd) @ V)
             for p in panels]
    if w is None:
        RV, IV = prods[0]
    else:
        RV = w[0] * prods[0][0] + w[1] * prods[1][0]
        IV = w[0] * prods[0][1] + w[1] * prods[1][1]
    return torch.complex(RV[:, :R] - IV[:, R:], RV[:, R:] + IV[:, :R]).T


def panel_matvec(G_re, G_im, k: int, v, *, g_lo=None,
                 g_w=None) -> torch.Tensor:
    """One step's product G_k v for (R, n) rows v, outside the kernel:
    panel k, or with the lerp tables the weighted pair of samples
    g_lo[k], g_lo[k] + 1.  The rounding is the plain sweep's, which the
    kernel matches: planes widened to v's float type, float32 weights
    widened likewise and applied to the two panels' products.  The
    distributed sweep takes the carry across a band seam with it."""
    if g_lo is None:
        return _panels_matvec(G_re, G_im, (k,), v)
    lo = int(g_lo[k])
    return _panels_matvec(G_re, G_im, (lo, lo + 1), v,
                          g_w[k].to(v.real.dtype))


def plain_sweep(G_re, G_im, u, c, carry0, *, mode: str, g_lo=None,
                g_w=None) -> torch.Tensor:
    """The recursion as a Python loop of dense products: the plain version
    of the kernel, for the same arguments as `sweep`.  The stored planes
    (any float type) are widened to the vector's float type and multiplied
    at full precision; the float32 lerp weights are widened likewise and
    applied to the two panels' products, not to the panels.  A tridiagonal
    coupling is applied with shifted slices, which never touch sub[0] and
    sup[n-1]."""
    S, R, n, shared, lerp = _check_args(G_re, G_im, u, c, carry0, mode,
                                        g_lo, g_w)
    batched = u.ndim == 3
    tri = c.ndim == 3
    U = u if batched else u[:, None]
    out = torch.empty_like(U)
    if lerp:
        lo = g_lo[:S].tolist()
        w = g_w[:S].to(u.real.dtype)
        g_matvec = lambda k, v: _panels_matvec(G_re, G_im, (lo[k], lo[k] + 1),
                                               v, w[k])
    else:
        g_matvec = lambda k, v: _panels_matvec(G_re, G_im,
                                               (0 if shared else k,), v)

    def couple(ck, v):
        """c[k] applied to the (R, n) rows v."""
        if not tri:
            return ck * v
        y = ck[1] * v
        y[:, 1:] += ck[0, 1:] * v[:, :-1]
        y[:, :-1] += ck[2, :-1] * v[:, 1:]
        return y

    other = carry0 if batched else carry0[None]
    steps = range(S) if mode == "fwd" else range(S - 1, -1, -1)
    for k in steps:
        if mode == "fwd":
            new = U[k] - couple(c[k], g_matvec(k, other))
        elif mode == "bwd":
            new = g_matvec(k, U[k] - couple(c[k], other))
        else:
            new = U[k] - g_matvec(k, U[k] + couple(c[k], other))
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
    _operand_bytes(width, G_re.shape[-1])


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
                 by the right-hand sides; or (S, 3, n), the [sub, diag, sup]
                 rows of a TRIDIAGONAL coupling (9-point scheme):
                 (c[k] v)[i] = sub[i] v[i-1] + diag[i] v[i] + sup[i] v[i+1].
                 sub[:, 0] and sup[:, n-1] are never read.  Which of the two
                 is meant follows from the rank.
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
    launch counters count each chunk.  A launch the runtime refuses raises.

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
    tri = c.ndim == 3
    # two rows of scratch: fwd with tridiagonal coupling parks each step's
    # raw product there for the next step to finish, bwd / bwd_sub with
    # diagonal coupling the next step's operand (see the source note)
    scratch = (torch.empty((2, min(R, MAX_WIDTH), n), dtype=u.dtype,
                           device=u.device)
               if tri == (mode == "fwd") else None)
    lib = build.library()
    sm_count = _sm_count(u.device)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream().cuda_stream
        for r0 in range(0, R, MAX_WIDTH):
            width = min(MAX_WIDTH, R - r0)
            plan = launch_plan(n, width, G_re.element_size(), lerp, shared,
                               sm_count)
            skip = r0 * n * 8           # bytes to the chunk's first row
            status = lib.hh_sweep(
                MODES.index(mode), int(G_re.dtype == torch.bfloat16),
                G_re.data_ptr(), G_im.data_ptr(), 0 if shared else n * ld,
                ld, n, S, width, R * n,
                g_lo.data_ptr() if lerp else None,
                g_w.data_ptr() if lerp else None,
                u.data_ptr() + skip, c.data_ptr(), int(tri),
                carry0.data_ptr() + skip, out.data_ptr() + skip,
                scratch.data_ptr() if scratch is not None else None,
                plan.blocks, plan.rows_per_block, plan.stages, stream)
            build.check(status, f"sweep[{mode}]")
            _count(mode, width, lerp, tri, shared)
            plans_by_variant[(mode, width, lerp, tri, shared)] = plan
    return out
