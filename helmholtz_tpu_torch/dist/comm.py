"""The three moves of the distributed path, on `torch.distributed`.

The JAX package moves data between the layer bands with `lax.ppermute`
(halo rows of the operator product, the staged sweep's carries) and
`lax.psum` (the Krylov inner products).  Here each rank is a process that
holds its band of rows, and the moves are explicit calls:

  exchange_halo  one row to each neighbour and one from each, around every
                 band product (the two `ppermute`s of `dist/spmv.py`);
  pass_carry / await_carry
                 the hand-off of a sweep's carry row from one band to the
                 next (the stage `ppermute`s of `dist/sweep.py`);
  allreduce_sum  the sum over the ranks of a small tensor (`psum`).

How a move travels depends on the process group's backend:

  * NCCL (every rank has a card of its own): the tensors move from device
    memory to device memory, point-to-point through `batch_isend_irecv`
    and the sum through `all_reduce`, on the current stream.
  * gloo (the CPU, or ranks that share a card): gloo's point-to-point
    calls take host tensors only, so a CUDA tensor is staged through host
    memory: copied to the host, sent, received into host memory and copied
    to the device.  The sum is staged the same way.  The compute stays on
    the card; only the rows and the sums cross the host.

Every function takes the band's `LayerMesh` (`dist.partition`) for its
rank and size; on a mesh of one rank every move is the identity (no
neighbours, a sum over one term), so the distributed functions also run
without a process group.
"""
from __future__ import annotations

import torch
import torch.distributed as dist


def _staged(mesh, t: torch.Tensor) -> bool:
    """Whether a move of `t` goes through host memory: gloo with a CUDA
    tensor."""
    return mesh.backend == "gloo" and t.device.type == "cuda"


def _wire(t: torch.Tensor) -> torch.Tensor:
    """The real view of a tensor as it travels (complex as pairs of reals),
    contiguous."""
    t = t.contiguous()
    return torch.view_as_real(t) if t.is_complex() else t


def _recv_buffer(like: torch.Tensor, staged: bool) -> torch.Tensor:
    """An empty buffer for a tensor shaped like `like` as it travels: on
    the host when `staged`, else on `like`'s device.  Allocated, not
    copied: nothing crosses to the host to learn a shape."""
    shape = (*like.shape, 2) if like.is_complex() else like.shape
    dtype = like.real.dtype if like.is_complex() else like.dtype
    return torch.empty(shape, dtype=dtype,
                       device="cpu" if staged else like.device)


def _unwire(w: torch.Tensor, like: torch.Tensor) -> torch.Tensor:
    return torch.view_as_complex(w) if like.is_complex() else w


class HaloExchange:
    """A posted halo exchange; `wait()` returns (below, above): the last row
    of the band below and the first row of the band above, zeros at the
    ends of the domain.  Posted before the band's interior product and
    waited on after it."""

    def __init__(self, mesh, u: torch.Tensor):
        self.like = u[..., 0, :]
        self.device = u.device
        self.staged = _staged(mesh, u)
        r, D = mesh.rank, mesh.size
        host = (lambda t: t.cpu()) if self.staged else (lambda t: t)
        self.bufs = {}
        ops = []
        if D > 1:
            if r > 0:
                self.bufs["below"] = _recv_buffer(self.like, self.staged)
                ops += [(dist.isend, _wire(host(u[..., 0, :])), r - 1),
                        (dist.irecv, self.bufs["below"], r - 1)]
            if r < D - 1:
                self.bufs["above"] = _recv_buffer(self.like, self.staged)
                ops += [(dist.isend, _wire(host(u[..., -1, :])), r + 1),
                        (dist.irecv, self.bufs["above"], r + 1)]
        # the sent rows stay referenced until the exchange is waited on
        self.sent = [t for op, t, _ in ops if op is dist.isend]
        self.works = _post(mesh, ops)

    def wait(self):
        for w in self.works:
            w.wait()
        out = []
        for key in ("below", "above"):
            w = self.bufs.get(key)
            if w is None:
                out.append(torch.zeros_like(self.like))
            else:
                out.append(_unwire(w, self.like).to(self.device))
        return tuple(out)


def _post(mesh, ops):
    """Post point-to-point operations [(isend | irecv, tensor, peer)]:
    NCCL takes them as one batch, gloo one by one."""
    if not ops:
        return []
    if mesh.backend == "nccl":
        return dist.batch_isend_irecv(
            [dist.P2POp(op, t, peer) for op, t, peer in ops])
    return [op(t, peer) for op, t, peer in ops]


def exchange_halo(mesh, u: torch.Tensor) -> HaloExchange:
    """Post the exchange of a band's edge rows: u is (..., n_loc, n); its
    row 0 goes to the rank below (its `above`) and its row n_loc-1 to the
    rank above (its `below`).  Returns the posted exchange; call `wait()`
    for the received rows."""
    return HaloExchange(mesh, u)


def pass_carry(mesh, carry: torch.Tensor, *, up: bool) -> None:
    """Hand a sweep's carry (B, n) to the next band: the rank above (`up`,
    the forward sweep) or the rank below (the backward sweep).  Returns
    when the carry has left (gloo: when the peer has it)."""
    peer = mesh.rank + (1 if up else -1)
    w = _wire(carry.cpu() if _staged(mesh, carry) else carry)
    for work in _post(mesh, [(dist.isend, w, peer)]):
        work.wait()


def await_carry(mesh, like: torch.Tensor, *, up: bool) -> torch.Tensor:
    """Receive the carry that `pass_carry` sent to this rank: from the rank
    below (`up`, the forward sweep) or the rank above; shaped like `like`
    and on its device."""
    peer = mesh.rank - (1 if up else -1)
    buf = _recv_buffer(like, _staged(mesh, like))
    for work in _post(mesh, [(dist.irecv, buf, peer)]):
        work.wait()
    return _unwire(buf, like).to(like.device)


def allreduce_sum(mesh, t: torch.Tensor) -> torch.Tensor:
    """The sum of `t` over the ranks, on every rank (a new tensor; `t` is
    left as it was).  Every rank gets the same bits, so host decisions
    taken on the result agree."""
    if mesh.size == 1:
        return t
    staged = _staged(mesh, t)
    w = _wire(t.cpu() if staged else t).clone()
    dist.all_reduce(w, op=dist.ReduceOp.SUM)
    return _unwire(w, t).to(t.device)


def all_gather_rows(mesh, band: torch.Tensor, axis: int = 0) -> torch.Tensor:
    """The global tensor from every rank's band along `axis` (the grid-row
    axis), on every rank.  Used for results and checks, not on the solve
    path."""
    if mesh.size == 1:
        return band
    w = _wire(band.cpu() if _staged(mesh, band) else band)
    parts = [torch.empty_like(w) for _ in range(mesh.size)]
    dist.all_gather(parts, w)
    out = torch.cat([_unwire(p, band) for p in parts], dim=axis)
    return out.to(band.device)


def all_gather_object(mesh, obj) -> list:
    """Every rank's `obj`, in rank order, on every rank."""
    if mesh.size == 1:
        return [obj]
    out = [None] * mesh.size
    dist.all_gather_object(out, obj)
    return out


def barrier(mesh) -> None:
    if mesh.size > 1:
        dist.barrier()
