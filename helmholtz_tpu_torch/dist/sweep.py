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
`ops.kernels.sweep.sweep`) per direction, in the launches that
`launch_widths` gives (one for the whole batch over a dense band with
diagonal coupling, else chunks of at most four), with the received carry
as `carry0`: dense or band-local lerp tables,
diagonal (5-point) or tridiagonal (9-point) coupling, modes fwd / bwd /
bwd_sub.  On the CPU the wrapper runs its plain loop.  The F rows j < b and
row b live on rank 0 (b < n_loc): their G panels are zero (zero weights
when compressed), so the forward recursion leaves them as they are, and
the backward sweep's values there are replaced by the F-block closure.
"""
from __future__ import annotations

import functools

import torch

from ..ops.kernels.sweep import (_sm_count, launch_widths, panel_matvec,
                                  sweep)
from ..precond.sweeping import block_thomas_solve, couple, rows_outermost
from . import comm

#: sweep chunks (`launch_widths` of the band's batch) of the applies made
#: in this process: each is one launch of the sweep kernel per direction
apply_chunks = 0


def reset_counts() -> None:
    global apply_chunks
    apply_chunks = 0


def dist_apply_preconditioner(mesh, S, f_band: torch.Tensor) -> torch.Tensor:
    """u ~= (A^{-1} f) on this rank's band, for either stencil's state
    (`DistSweepState`, or `DistSweepState9`, for which the JAX package has
    `dist_apply_preconditioner9`): f_band (n_loc, n) or a batch
    (B, n_loc, n), left untouched.  Every rank of the mesh must call it
    with the same batch.  The algebra of `precond.sweeping.apply_rows`, on
    the band's rows (outermost, as the sweeps take them), with its
    coupling product and block-Thomas solve."""
    global apply_chunks
    run = functools.partial(sweep, g_lo=S.g_lo, g_w=S.g_w)
    hf_lo, hf_up, a_lo, a_up = S.couplings
    thomas = lambda r: block_thomas_solve(S.TF, hf_lo, hf_up, r)
    squeeze = f_band.ndim == 2
    u = rows_outermost(f_band[None] if squeeze else f_band)  # (n_loc, B, n)
    n_loc, B, n = u.shape
    b = S.b
    r, D = mesh.rank, mesh.size
    apply_chunks += len(launch_widths(B, n, S.G_re.element_size(),
                                      S.g_lo is not None, False,
                                      a_lo.ndim == 3, _sm_count(u.device)))

    # H_F solve and the row-b correction (rank 0; b < n_loc)
    if r == 0:
        TFuF = thomas(u[:b])
        u[b] -= couple(a_lo[b], TFuF[b - 1])

    # forward sweep: the carry from the band below enters row 0, the
    # kernel runs rows 1..n_loc-1, the last row's product goes up
    if r > 0:
        t = comm.await_carry(mesh, u[0], up=True)
        u[0] -= couple(a_lo[0], t)
    if n_loc > 1:
        u[1:] = run(S.G_re, S.G_im, u[1:], a_lo[1:], u[0], mode="fwd")
    if r < D - 1:
        comm.pass_carry(mesh, panel_matvec(S.G_re, S.G_im, n_loc - 1, u[-1],
                                           g_lo=S.g_lo, g_w=S.g_w), up=True)

    # fused diagonal + backward sweep: the row above the band enters the
    # last row's coupling (zero, with a zeroed coupling, at the top of the
    # domain); the band's first row goes down
    if r < D - 1:
        nxt = comm.await_carry(mesh, u[-1], up=False)
        c_up = a_up
    else:
        nxt = torch.zeros_like(u[-1])
        c_up = torch.cat([a_up[:-1], torch.zeros_like(a_up[-1:])], dim=0)
    u = run(S.G_re, S.G_im, u, c_up, nxt,
            mode="bwd" if S.d2_replace else "bwd_sub")
    if r > 0:
        comm.pass_carry(mesh, u[0], up=False)

    # F-block closure (rank 0): u_F = T_F u_F - T_F (A_{F,b} u_b)
    if r == 0:
        rhs = torch.zeros_like(TFuF)
        rhs[b - 1] = couple(a_up[b - 1], u[b])
        u[:b] = TFuF - thomas(rhs)
    return u[:, 0] if squeeze else u.transpose(0, 1).contiguous()
