"""1-D layer partitioning of the Helmholtz problem over ranks.

The operator's layer-block structure is already a 1-D domain
decomposition: rank d owns the contiguous band of grid rows
[d * n_loc, (d + 1) * n_loc).  Everything row-indexed (the solution and
right-hand-side grids, the stencil fields of A, the inter-layer couplings
and the corner inverses G) is held by the rank of its band as ordinary
tensors on the rank's device; the small H_F factors are held by every rank.

G is stored ROW-ALIGNED: panel k of a band acts on the band's row k, and
the F rows j < b (rank 0 only) get zero panels, so every sweep step finds
its panel locally.  A sample-compressed stack (g_stride > 0) is laid out
per band instead: each rank holds the contiguous window of GLOBAL samples
that its rows' brackets touch (bands overlap by one sample at the seams,
so no row needs a neighbour's samples), with per-row LOCAL indices and
float32 weights that carry the single-card interpolant exactly.

The mesh is the process group (`dist.launch`, `dist.multihost`): a
`LayerMesh` names this process's rank, the group's size, the rank's device
and the backend.  A mesh of one rank needs no process group.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.distributed as dist

from .._device import resolve_device
from ..precond.sweeping import band_sample_window

LAYER_AXIS = "layers"


@dataclasses.dataclass(frozen=True)
class LayerMesh:
    """The ranks that share the grid rows, seen from one rank: `size`
    ranks, this one `rank`, computing on `device`; `backend` is the process
    group's ("nccl" or "gloo"), None for one rank without a group."""

    size: int
    rank: int
    device: torch.device
    backend: Optional[str] = None
    axis_name: str = LAYER_AXIS

    def band(self, L: int) -> tuple[int, int]:
        """(n_loc, first global row) of this rank's band of L rows."""
        if L % self.size:
            raise ValueError(f"grid rows {L} not divisible by {self.size} "
                             "devices")
        n_loc = L // self.size
        return n_loc, self.rank * n_loc


def make_mesh(n_devices: Optional[int] = None, axis_name: str = LAYER_AXIS,
              device=None) -> LayerMesh:
    """The layer mesh of this process: the initialized process group (from
    `dist.launch.run_ranks`, `dist.multihost.initialize` or `torchrun`),
    whose size must be `n_devices` when that is given.  Without a process
    group only a mesh of one rank exists.  The rank's device is the one the
    launcher gave it, else `device` (default the card)."""
    from . import launch

    if dist.is_available() and dist.is_initialized():
        size = dist.get_world_size()
        if n_devices is not None and n_devices != size:
            raise ValueError(
                f"requested {n_devices} mesh devices but the process group "
                f"has {size} ranks")
        dev = launch.rank_device() or resolve_device(device or "cuda")
        return LayerMesh(size, dist.get_rank(), dev, dist.get_backend(),
                         axis_name)
    if n_devices not in (None, 1):
        raise ValueError(
            f"requested {n_devices} mesh devices but no process group is "
            "initialized: start the ranks with dist.launch.run_ranks, "
            "dist.multihost.initialize or torchrun")
    return LayerMesh(1, 0, resolve_device(device or "cuda"), None, axis_name)


def check_band(L: int, b: int, mesh: LayerMesh) -> int:
    """n_loc for L rows on the mesh; raises unless the rows divide evenly
    and the F band and row b sit on rank 0 (b < n_loc)."""
    n_loc, _ = mesh.band(L)
    if b >= n_loc:
        raise ValueError(f"PML width b={b} must be < rows-per-device "
                         f"{n_loc}")
    return n_loc


@dataclasses.dataclass(frozen=True)
class DistSweepState:
    """One rank's band of the 5-point sweeping state.

    G_re, G_im : dense (g_stride == 0): (n_loc, n, ld) row-aligned panels,
           zero for the F rows; compressed: (Ms_loc, n, ld) SAMPLES, the
           band's window of the global sample stack.  The port's plane
           layout (`precond.sweeping`), pitch `g_ld(n)`.
    TF, hf_cs, hf_cn : H_F's block-Thomas stack (b, n, n) and couplings
           (b, n), the same on every rank.
    a_cs, a_cn : the band's rows of the operator's couplings, (n_loc, n).
    g_w, g_lo : (n_loc, 2) float32 and (n_loc,) int32 LOCAL sample index
           per band row (zero weights for the F rows); None when dense.
    """

    G_re: torch.Tensor
    G_im: torch.Tensor
    TF: torch.Tensor
    hf_cs: torch.Tensor
    hf_cn: torch.Tensor
    a_cs: torch.Tensor
    a_cn: torch.Tensor
    b: int
    d2_replace: bool
    g_w: Optional[torch.Tensor] = None
    g_lo: Optional[torch.Tensor] = None
    g_stride: int = 0

    @property
    def band_shape(self):
        return tuple(self.a_cs.shape)


@dataclasses.dataclass(frozen=True)
class DistSweepState9:
    """One rank's band of the 9-point sweeping state: `DistSweepState` with
    TRIDIAGONAL couplings, [sub, diag, sup] rows stacked (.., 3, n): hf_l,
    hf_u (b, 3, n) and a_l, a_u (n_loc, 3, n).  TF holds the values rounded
    to the G storage type, widened, as the single-card state does."""

    G_re: torch.Tensor
    G_im: torch.Tensor
    TF: torch.Tensor
    hf_l: torch.Tensor
    hf_u: torch.Tensor
    a_l: torch.Tensor
    a_u: torch.Tensor
    b: int
    d2_replace: bool
    g_w: Optional[torch.Tensor] = None
    g_lo: Optional[torch.Tensor] = None
    g_stride: int = 0

    @property
    def band_shape(self):
        return (self.a_l.shape[0], self.a_l.shape[-1])


def band_sample_windows(M: int, R: int, b: int, n_loc: int, D: int):
    """Each band's inclusive window (s0, s1) of the stride-R global sample
    stack over M sweep rows, and the widest window's length: the one
    geometry of the compressed band layout (setup, converter, planner)."""
    windows = [band_sample_window(M, R, max(d * n_loc, b) - b,
                                  (d + 1) * n_loc - 1 - b) for d in range(D)]
    return windows, max(s1 - s0 + 1 for s0, s1 in windows)


def _band_g(P, L: int, n_loc: int, j0: int, D: int, rank: int):
    """The band's G planes and table fields from a single-card state."""
    b = P.b
    dev = P.G_re.device
    rows = torch.arange(j0, j0 + n_loc, device=dev)
    valid = rows >= b
    if P.g_stride:
        M = L - b
        windows, ms_loc = band_sample_windows(M, P.g_stride, b, n_loc, D)
        s0 = windows[rank][0]
        Ms = P.G_re.shape[0]
        sidx = torch.clamp(s0 + torch.arange(ms_loc, device=dev), max=Ms - 1)
        k = torch.clamp(rows - b, 0, M - 1)
        g_lo = torch.where(valid, P.g_lo[k] - s0, 0).to(torch.int32)
        g_w = torch.where(valid[:, None], P.g_w[k], 0.0).to(torch.float32)
        return (P.G_re[sidx], P.G_im[sidx],
                dict(g_w=g_w, g_lo=g_lo, g_stride=P.g_stride))
    if P.G_re.shape[0] != L - b:
        raise ValueError(f"a dense stack of {P.G_re.shape[0]} panels for "
                         f"{L - b} sweep rows: the shared-panel layout has "
                         "no band form")
    G = []
    for plane in (P.G_re, P.G_im):
        band = torch.zeros((n_loc, *plane.shape[1:]), dtype=plane.dtype,
                           device=dev)
        first = max(j0, b)
        if first < j0 + n_loc:
            band[first - j0:] = plane[first - b:j0 + n_loc - b]
        G.append(band)
    return G[0], G[1], {}


def dist_state_from_preconditioner(P, mesh: LayerMesh):
    """This rank's band state of a single-card `SweepingPreconditioner` or
    `SweepingPreconditioner9`: row-aligned G (zero panels for the F rows),
    or for a sample-compressed stack the band's sample window with local
    tables, so the distributed operator equals the single-card one value
    for value."""
    nine = hasattr(P, "a_l")
    L = (P.a_l if nine else P.a_cs).shape[0]
    n_loc = check_band(L, P.b, mesh)
    _, j0 = mesh.band(L)
    G_re, G_im, tables = _band_g(P, L, n_loc, j0, mesh.size, mesh.rank)
    band = lambda t: t[j0:j0 + n_loc].contiguous()
    if nine:
        return DistSweepState9(
            G_re=G_re, G_im=G_im, TF=P.TF, hf_l=P.hf_l, hf_u=P.hf_u,
            a_l=band(P.a_l), a_u=band(P.a_u), b=P.b,
            d2_replace=P.d2_replace, **tables)
    return DistSweepState(
        G_re=G_re, G_im=G_im, TF=P.TF, hf_cs=P.hf_cs, hf_cn=P.hf_cn,
        a_cs=band(P.a_cs), a_cn=band(P.a_cn), b=P.b,
        d2_replace=P.d2_replace, **tables)


def shard_problem(mesh: LayerMesh, A, P, f_grid: torch.Tensor,
                  f_axis: int = 0):
    """This rank's band of a global problem: (A_band, state, f_band).  A is
    a Stencil5 or Stencil9 of (L, n) fields, P its single-card
    preconditioner or None, and f_grid has its grid rows on `f_axis` (1 for
    a batch (B, L, n)).  Everything moves to the mesh's device."""
    L = A.cc.shape[0]
    n_loc, j0 = mesh.band(L)
    dev = mesh.device
    A_band = A.map(lambda f: f[j0:j0 + n_loc].contiguous().to(dev))
    state = None
    if P is not None:
        state = dist_state_from_preconditioner(P, mesh)
        state = dataclasses.replace(state, **{
            f.name: getattr(state, f.name).to(dev)
            for f in dataclasses.fields(state)
            if isinstance(getattr(state, f.name), torch.Tensor)})
    f_band = f_grid.narrow(f_axis, j0, n_loc).contiguous().to(dev)
    return A_band, state, f_band
