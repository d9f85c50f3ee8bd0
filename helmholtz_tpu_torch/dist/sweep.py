"""The sweeping preconditioner applied across the bands: a staged sweep.

The sweep recursion u_j <- u_j - cs_j (G_{j-1} u_{j-1}) is sequential in j,
so across the bands it runs as a pipeline: rank d waits for the carry of
rank d-1, sweeps its band and hands its own carry on (`dist.comm`); the
backward sweep runs the other way.  The wall-clock time is the serial
sweep's, as the recursion demands; a batch of right-hand sides rides the
same schedule and one pass of each band's G.

The forward carry between bands is t = G_last u_last, the band's last row
already multiplied by its panel, so each rank only needs its own G.  That
one-panel product at the seam is plain tensor code with the sweep's own
rounding (`ops.kernels.sweep.panel_matvec`): the planes widened to the
vector's float type, float32 lerp weights applied to the two samples'
products.

Each rank's band is ONE sweep through the sweep kernel (K2,
`ops.kernels.sweep.sweep`) per direction, R <= 4 right-hand sides a launch,
with the received carry as `carry0`: dense or band-local lerp tables,
diagonal (5-point) or tridiagonal (9-point) coupling, modes fwd / bwd /
bwd_sub.  On the CPU the wrapper runs its plain loop.  The F rows j < b and
row b live on rank 0 (b < n_loc): their G panels are zero (zero weights
when compressed), so the forward recursion leaves them as they are, and
the backward sweep's values there are replaced by the F-block closure.
"""
from __future__ import annotations

import functools

import torch

from ..ops.kernels.sweep import MAX_WIDTH, panel_matvec, sweep
from ..precond.sweeping import _block_thomas_solve_multi
from ..precond.sweeping9 import _block_thomas_solve9, _tridiag_matvec
from . import comm
from .partition import DistSweepState9

#: sweep chunks (ceil(B / MAX_WIDTH) for a batch of B) of the applies made
#: in this process: each is one launch of the sweep kernel per direction
apply_chunks = 0


def reset_counts() -> None:
    global apply_chunks
    apply_chunks = 0


def _couple(c, v, tri: bool):
    """The coupling row(s) c applied to the (B, n) rows v."""
    return _tridiag_matvec(*c, v) if tri else c * v


def dist_apply_preconditioner(mesh, S, f_band: torch.Tensor) -> torch.Tensor:
    """u ~= (A^{-1} f) on this rank's band, for either stencil's state
    (`DistSweepState`, or `DistSweepState9`, for which the JAX package has
    `dist_apply_preconditioner9`): f_band (n_loc, n) or a batch
    (B, n_loc, n), left untouched.  Every rank of the mesh must call it
    with the same batch."""
    global apply_chunks
    run = functools.partial(sweep, g_lo=S.g_lo, g_w=S.g_w)
    tri = isinstance(S, DistSweepState9)
    a_lo, a_up = (S.a_l, S.a_u) if tri else (S.a_cs, S.a_cn)
    if tri:
        thomas = lambda r: _block_thomas_solve9(S.TF, S.hf_l, S.hf_u, r)
    else:
        thomas = lambda r: _block_thomas_solve_multi(S.TF, S.hf_cs, S.hf_cn,
                                                     r)
    squeeze = f_band.ndim == 2
    u = (f_band[None] if squeeze else f_band).clone()     # (B, n_loc, n)
    B, n_loc, n = u.shape
    b = S.b
    r, D = mesh.rank, mesh.size
    to_sbn = lambda x: x.transpose(0, 1).contiguous()
    apply_chunks += -(-B // MAX_WIDTH)

    # H_F solve and the row-b correction (rank 0; b < n_loc)
    if r == 0:
        TFuF = thomas(u[:, :b])
        u[:, b] -= _couple(a_lo[b], TFuF[:, b - 1], tri)

    # forward sweep: the carry from the band below enters row 0, the
    # kernel runs rows 1..n_loc-1, the last row's product goes up
    if r > 0:
        t = comm.await_carry(mesh, u[:, 0], up=True)
        u[:, 0] -= _couple(a_lo[0], t, tri)
    if n_loc > 1:
        u[:, 1:] = run(S.G_re, S.G_im, to_sbn(u[:, 1:]), a_lo[1:],
                       u[:, 0].contiguous(), mode="fwd").transpose(0, 1)
    if r < D - 1:
        comm.pass_carry(mesh, panel_matvec(S.G_re, S.G_im, n_loc - 1,
                                           u[:, -1], g_lo=S.g_lo,
                                           g_w=S.g_w), up=True)

    # fused diagonal + backward sweep: the row above the band enters the
    # last row's coupling (zero, with a zeroed coupling, at the top of the
    # domain); the band's first row goes down
    if r < D - 1:
        nxt = comm.await_carry(mesh, u[:, -1], up=False)
        c_up = a_up
    else:
        nxt = torch.zeros_like(u[:, -1])
        c_up = torch.cat([a_up[:-1], torch.zeros_like(a_up[-1:])], dim=0)
    u_bwd = run(S.G_re, S.G_im, to_sbn(u), c_up, nxt,
                mode="bwd" if S.d2_replace else "bwd_sub").transpose(0, 1)
    if r > 0:
        comm.pass_carry(mesh, u_bwd[:, 0].contiguous(), up=False)

    # F-block closure (rank 0): u_F = T_F u_F - T_F (A_{F,b+1} u_b)
    if r == 0:
        rhs = torch.zeros_like(TFuF)
        rhs[:, b - 1] = _couple(a_up[b - 1], u_bwd[:, b], tri)
        u_bwd[:, :b] = TFuF - thomas(rhs)
    return u_bwd[0] if squeeze else u_bwd

