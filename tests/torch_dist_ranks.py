"""Rank-side work of the distributed parity tests: module-level functions
that `helmholtz_tpu_torch.dist.launch.run_ranks` runs on every rank.  This
module imports no JAX (each rank is a fresh process): the tests compute
the JAX side once in the test process and hand the ranks numpy arrays.
Each function gathers what the tests compare into rank 0's result."""
import numpy as np
import torch

from helmholtz_tpu_torch import convert
from helmholtz_tpu_torch.core.sparse import Stencil5, Stencil9
from helmholtz_tpu_torch.dist import comm, launch
from helmholtz_tpu_torch.dist import spmv as dspmv
from helmholtz_tpu_torch.dist import sweep as dsweep
from helmholtz_tpu_torch.dist.partition import make_mesh


def _gather(mesh, band, axis):
    return comm.all_gather_rows(mesh, band, axis).cpu().numpy()


def band_state(state_np, mesh):
    """This rank's band state from a JAX global distributed state given as
    numpy leaves ({"nine": bool, "g_dtype": "bf16" | None, fields...})."""
    kw = dict(state_np)
    nine = kw.pop("nine")
    g_dtype = {"bf16": torch.bfloat16, None: None}[kw.pop("g_dtype")]
    fn = convert.dist_state9_from_numpy if nine \
        else convert.dist_state_from_numpy
    return fn(**kw, rank=mesh.rank, n_devices=mesh.size, g_dtype=g_dtype,
              device="cpu")


def stencil(fields, nine):
    cls = Stencil9 if nine else Stencil5
    return cls(*(torch.from_numpy(np.array(f)) for f in fields))


def spmv_and_apply(device, spmv_cases, apply_cases):
    """The halo band products and the staged applies of the given cases,
    gathered; with the transport checks: every rank's all-reduced sum has
    the same bits, and one apply and one 5-point product count as such."""
    mesh = make_mesh(device=device)
    out = {"backend": mesh.backend, "size": mesh.size}
    for name, fields, u, nine in spmv_cases:
        A = stencil(fields, nine)
        n_loc, j0 = mesh.band(A.cc.shape[0])
        band = lambda t: t[..., j0:j0 + n_loc, :].contiguous()
        y = dspmv.halo_matvec(mesh, A.map(band),
                              band(torch.from_numpy(u)))
        out[f"spmv_{name}"] = _gather(mesh, y, y.dim() - 2)
    for name, state_np, F in apply_cases:
        S = band_state(state_np, mesh)
        n_loc = S.band_shape[0]
        F = torch.from_numpy(F)
        F_band = F.narrow(F.dim() - 2, mesh.rank * n_loc, n_loc)
        dsweep.reset_counts()
        u = dsweep.dist_apply_preconditioner(mesh, S, F_band.contiguous())
        out[f"apply_{name}"] = _gather(mesh, u, u.dim() - 2)
        out[f"chunks_{name}"] = comm.all_gather_object(mesh,
                                                       dsweep.apply_chunks)
    x = torch.tensor([1.0 / 3.0 + mesh.rank, 2.0 ** -30 * (mesh.rank + 1)],
                     dtype=torch.float64)
    out["allreduce_bits"] = comm.all_gather_object(
        mesh, comm.allreduce_sum(mesh, x).numpy().tobytes())
    u = torch.full((2, 3, 5), float(mesh.rank), dtype=torch.complex128)
    below, above = comm.exchange_halo(mesh, u).wait()
    out["halo_rows"] = comm.all_gather_object(
        mesh, (below.real.mean().item(), above.real.mean().item()))
    out["launch_device"] = str(launch.rank_device())
    return out


def failing_rank(device, bad_rank, hang):
    """Raises on `bad_rank` (or sleeps there past any limit, with `hang`)
    while the others wait in a collective."""
    import time

    mesh = make_mesh(device=device)
    if mesh.rank == bad_rank:
        if hang:
            time.sleep(600)
        raise RuntimeError(f"rank {bad_rank} raises on purpose")
    comm.barrier(mesh)
    return "unreachable"


def _leaves(S):
    """A band state's tensors as numpy (None where absent)."""
    out = {}
    for k in ("G_re", "G_im", "TF", "g_w", "g_lo"):
        v = getattr(S, k)
        out[k] = None if v is None else v.float().numpy() \
            if v.dtype == torch.bfloat16 else v.numpy()
    return out


def factor_cases(device, cases, jax_states, n, b):
    """Each case's band setup (`dist.factor`) on every rank, gathered; the
    band state `convert` makes of the JAX state of the same case, against
    the rank's own; what each rank holds; and the assemble-only setups
    against the full ones."""
    from helmholtz_tpu_torch.dist import factor as dfactor

    mesh = make_mesh(device=device)
    out = {}
    for name, nine, kw in cases:
        fn = dfactor.distributed_setup9 if nine else dfactor.distributed_setup
        A, S, f = fn(mesh, n, b, 2.0, 20.0, 2.0, "c1_f1", **kw)
        mine = _leaves(S)
        rows = lambda t: _gather(mesh, t, 0)
        out[name] = {
            "G_re": rows(S.G_re[:, :, :n]), "G_im": rows(S.G_im[:, :, :n]),
            "TF": mine["TF"], "f": rows(f),
            "A": [rows(fld) for fld in A.fields()],
            "couplings": [rows(c) for c in
                          ((S.a_l, S.a_u) if nine else (S.a_cs, S.a_cn))],
            "tables": None if S.g_w is None else (rows(S.g_w),
                                                  rows(S.g_lo)),
            "held": comm.all_gather_object(mesh, (
                tuple(S.G_re.shape), tuple(S.G_im.shape),
                tuple((S.a_l if nine else S.a_cs).shape))),
        }
        theirs = _leaves(band_state(jax_states[name], mesh))
        diff = {k: (float(np.abs(theirs[k][:, :, :n] - mine[k][:, :, :n])
                          .max()) if k.startswith("G")
                    else float(np.abs(theirs[k] - mine[k]).max()))
                for k in mine if mine[k] is not None}
        out[name]["convert_diff"] = comm.all_gather_object(mesh, diff)
        if not kw.get("factor_stride", 1) > 1 or kw.get("g_compress"):
            asm = dfactor.distributed_assemble9 if nine \
                else dfactor.distributed_assemble
            A2, S2, f2 = asm(mesh, n, b, 2.0, 20.0, 2.0, "c1_f1")
            same = all(torch.equal(x, y) for x, y in
                       zip(A.fields() + (f, S.TF), A2.fields() + (f2, S2.TF)))
            out[name]["assemble_same"] = comm.all_gather_object(
                mesh, (same, S2.G_re.shape[0]))
    return out


def solve_cases(device, cases, multisolves, dryrun_n):
    """The distributed solves of the given cases on the bands of the JAX
    states, gathered; `run_multisolve(mesh_devices=size)` of each config
    (in place: the process group is already there); the dry run at
    `dryrun_n`."""
    from helmholtz_tpu_torch import driver
    from helmholtz_tpu_torch.dist import dryrun
    from helmholtz_tpu_torch.dist.solve import distributed_solve

    mesh = make_mesh(device=device)
    out = {}
    for name, state_np, fields, F, kw in cases:
        S = band_state(state_np, mesh)
        n_loc, n = S.band_shape
        A = stencil(fields, False)
        j0 = mesh.rank * n_loc
        A_band = A.map(lambda t: t[j0:j0 + n_loc].contiguous())
        F = torch.from_numpy(F)
        F_band = F.narrow(F.dim() - 2, j0, n_loc).contiguous()
        res = distributed_solve(mesh, A_band, S, F_band, **kw)
        x = res.x.reshape(*F_band.shape)
        out[name] = {"iterations": np.asarray(res.iterations).tolist(),
                     "converged": np.asarray(res.converged).tolist(),
                     "x": _gather(mesh, x, x.dim() - 2)}
    for name, args, kw in multisolves:
        out["multi_" + name] = driver.run_multisolve(
            *args, mesh_devices=mesh.size, device="cpu", **kw)
    out["dryrun"] = dryrun.dryrun_multichip(mesh.size, n=dryrun_n,
                                            device="cpu")
    return out
