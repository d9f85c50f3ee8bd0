"""The port's distributed band product and staged apply against the JAX
package's on the CPU, in complex128.

The JAX side runs `halo_stencil_matvec(9)` and
`dist_apply_preconditioner(9)` inside `shard_map` on `make_mesh(4)` (the
virtual CPU devices `conftest.py` sets); the port's side runs four gloo
ranks (`dist.launch.run_ranks`, one spawn for the whole module,
`torch_dist_ranks.spmv_and_apply`), each given its band of the JAX
distributed state through `convert.dist_state_from_numpy`.  Both are also
held against the port's single-card product and apply.  Tolerances:
1e-12 relative for the products, 1e-10 for the applies."""
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as P

from helmholtz_tpu import PartitionConfig as JPartitionConfig
from helmholtz_tpu.core.complexlib import CArray
from helmholtz_tpu.dist import make_mesh as j_make_mesh
from helmholtz_tpu.dist import partition as jpart
from helmholtz_tpu.dist import spmv as jdspmv
from helmholtz_tpu.dist import sweep as jdsweep
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu.precond import sweeping9 as jsweep9
from helmholtz_tpu_torch.dist import launch, make_mesh
from helmholtz_tpu_torch.dist import sweep as dsweep
from helmholtz_tpu_torch.ops import spmv as tspmv
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.precond import sweeping9 as tsweep9

import helmholtz_tpu_torch as ht
import torch_dist_ranks
from torch_parity import (FIELDS, FIELDS9, port_problems,  # noqa: F401
                          port_problems9, precond9_to_torch, precond_to_torch,
                          random_grid, to_np)

NDEV = 4
N, B = 32, 3
B_EDGE = N // NDEV - 1          # b = n_loc - 1: row b is rank 0's last row
APPLY_CASES = ("dense", "compressed", "bf16", "batched", "boundary", "nine")


def _jax_dist(fn, state, F, specs):
    f_spec = P("layers") if F.ndim == 2 else P(None, "layers")
    body = lambda S, f: fn(S, f, axis_name="layers", n_devices=NDEV,
                           n_rows_global=N, impl="xla")
    return np.asarray(jax.jit(jax.shard_map(
        body, mesh=j_make_mesh(NDEV), in_specs=(specs, f_spec),
        out_specs=f_spec, check_vma=False))(state, jnp.asarray(F)))


def _plane(a):
    return np.asarray(jnp.asarray(a, jnp.float32)
                      if a.dtype == jnp.bfloat16 else a)


def _state_np(S, nine, g_dtype=None):
    """A JAX global distributed state as the numpy leaves the ranks take."""
    out = dict(nine=nine, g_dtype=g_dtype, G_re=_plane(S.G_pad.re),
               G_im=_plane(S.G_pad.im), b=S.b, d2_replace=S.d2_replace, n=N)
    if nine:
        out.update(TF=_plane(S.TF.re) + 1j * _plane(S.TF.im),
                   **{k: getattr(S, k).to_np()
                      for k in ("hf_l", "hf_u", "a_l", "a_u")})
    else:
        out.update(TF=S.TF.to_np(), **{k: getattr(S, k).to_np() for k in
                                       ("hf_cs", "hf_cn", "a_cs", "a_cn")})
    if S.g_stride:
        out.update(g_w=np.asarray(S.g_w), g_lo=np.asarray(S.g_lo),
                   g_stride=S.g_stride)
    return out


def _dist_state9(P9):
    """The JAX row-aligned 9-point distributed state of a dense P9."""
    pad = jnp.zeros((P9.b, N, N), P9.G.re.dtype)
    return jpart.DistSweepState9(
        G_pad=CArray(jnp.concatenate([pad, P9.G.re]),
                     jnp.concatenate([pad, P9.G.im])),
        TF=P9.TF, hf_l=P9.hf_l, hf_u=P9.hf_u, a_l=P9.a_l, a_u=P9.a_u,
        b=P9.b, d2_replace=P9.d2_replace)


@pytest.fixture(scope="module")
def sides():
    """Everything both sides compute, once: the JAX distributed results,
    the port's single-card ones, and one run of the port's four ranks."""
    _, jprob, jhm, tprob, _ = port_problems(N, B, 2.0, 20.0)
    _, jprob7, jhm7, tprob7, _ = port_problems(N, B_EDGE, 2.0, 20.0)
    _, (jA9, jhm9, _, _), (tA9, _, _, _) = port_problems9(N, B, 2.0, 20.0)
    u = random_grid(0, (N, N))
    u2 = random_grid(1, (2, N, N))
    setups = {
        "dense": (jprob.A, jhm, B, {}),
        "compressed": (jprob.A, jhm, B, dict(factor_stride=3,
                                             g_compress=True)),
        "bf16": (jprob.A, jhm, B, dict(g_dtype=jnp.bfloat16)),
        "boundary": (jprob7.A, jhm7, B_EDGE, {}),
    }
    jax_out, single, cases, factored = {}, {}, [], {}
    for name in APPLY_CASES:
        F = u2 if name == "batched" else u
        if name == "nine":
            P9 = jsweep9.setup_preconditioner9(jA9, jhm9, B)
            S = _dist_state9(P9)
            fn, nine, g = jdsweep.dist_apply_preconditioner9, True, None
            single[name] = tsweep9.apply_preconditioner9(
                precond9_to_torch(P9, N), torch.from_numpy(F)).numpy()
        else:
            key = "dense" if name == "batched" else name
            if key not in factored:
                A, hm, b, kw = setups[key]
                factored[key] = jsweep.setup_preconditioner(A, hm, b, **kw)
            Pj = factored[key]
            S = jpart.dist_state_from_preconditioner(Pj, NDEV)
            fn, nine = jdsweep.dist_apply_preconditioner, False
            g = "bf16" if name == "bf16" else None
            Pt = precond_to_torch(Pj, N, g_dtype=torch.bfloat16 if g
                                  else None)
            single[name] = tsweep.apply_preconditioner_multi(
                Pt, torch.from_numpy(F.reshape(-1, N, N))).numpy() \
                .reshape(F.shape)
        jax_out[name] = _jax_dist(fn, S, F, jpart.state_partition_specs(S))
        cases.append((name, _state_np(S, nine, g), F))
    for name, A, nine in (("5pt", jprob.A, False), ("9pt", jA9, True)):
        fn = jdspmv.halo_stencil9_matvec if nine \
            else jdspmv.halo_stencil_matvec
        jax_out[f"spmv_{name}"] = np.asarray(jax.jit(jax.shard_map(
            lambda A_, v: fn(A_, v, "layers", NDEV), mesh=j_make_mesh(NDEV),
            in_specs=(jax.tree.map(lambda _: P("layers"), A), P("layers")),
            out_specs=P("layers")))(A, jnp.asarray(u)))
    single["spmv_5pt"] = tspmv.stencil_matvec(
        tprob.A, torch.from_numpy(u)).numpy()
    single["spmv_9pt"] = tspmv.stencil9_matvec(
        tA9, torch.from_numpy(u)).numpy()
    spmv_cases = [
        ("5pt", [to_np(f) for f in tprob.A.fields()], u, False),
        ("9pt", [to_np(f) for f in tA9.fields()], u, True)]
    ranks = launch.run_ranks(torch_dist_ranks.spmv_and_apply, NDEV,
                             device="cpu", spmv_cases=spmv_cases,
                             apply_cases=cases)
    return jax_out, single, ranks, cases


@pytest.mark.parametrize("stencil", ("5pt", "9pt"))
def test_halo_spmv_matches_jax(sides, stencil):
    jax_out, single, ranks, _ = sides
    got = ranks[f"spmv_{stencil}"]
    for ref in (jax_out[f"spmv_{stencil}"], single[f"spmv_{stencil}"]):
        np.testing.assert_allclose(got, ref, rtol=1e-12,
                                   atol=1e-12 * np.abs(ref).max())


@pytest.mark.parametrize("case", APPLY_CASES)
def test_staged_apply_matches_jax(sides, case):
    """Dense, sample-compressed and bfloat16 G, two right-hand sides on one
    schedule, the F band filling rank 0 but one row, the 9-point state:
    the port's staged apply equals JAX's and the single-card apply."""
    jax_out, single, ranks, _ = sides
    got = ranks[f"apply_{case}"]
    assert got.shape == jax_out[case].shape
    # bfloat16 G: the JAX package's XLA sweep multiplies the stored bf16
    # panels by the vector split into a hi + lo bf16 pair
    # (`precond.sweeping._g_dot`), the port (like its kernel) by the
    # vector itself with the panels widened; that split rounds at about
    # 2^-16 of the largest entry, so against JAX this case holds to 1e-4
    # and against the port's single-card apply, which rounds as the port
    # does, to 1e-10 like the others
    tol_jax = 1e-4 if case == "bf16" else 1e-10
    for ref, tol in ((jax_out[case], tol_jax), (single[case], 1e-10)):
        np.testing.assert_allclose(got, ref, rtol=tol,
                                   atol=tol * np.abs(ref).max())
    # one apply on every rank: one sweep chunk per direction
    assert ranks[f"chunks_{case}"] == [1] * NDEV


def test_transport_moves(sides):
    """gloo on the CPU; every rank's sum has the same bits (the host
    decisions of the GMRES agree); the halo rows come from the neighbours,
    zeros at the ends."""
    _, _, ranks, _ = sides
    assert ranks["backend"] == "gloo" and ranks["size"] == NDEV
    assert len(set(ranks["allreduce_bits"])) == 1
    want = [(r - 1.0 if r > 0 else 0.0, r + 1.0 if r < NDEV - 1 else 0.0)
            for r in range(NDEV)]
    assert ranks["halo_rows"] == want
    assert ranks["launch_device"] == "cpu"


def test_one_rank_mesh_needs_no_group(sides):
    """A mesh of one rank runs the distributed apply in this process and
    gives the single-card apply."""
    _, single, _, cases = sides
    name, state_np, F = cases[0]
    mesh = make_mesh(device="cpu")
    assert (mesh.size, mesh.rank, mesh.backend) == (1, 0, None)
    S = torch_dist_ranks.band_state(
        dict(state_np, G_re=state_np["G_re"], G_im=state_np["G_im"]),
        mesh)
    got = dsweep.dist_apply_preconditioner(mesh, S, torch.from_numpy(F))
    np.testing.assert_allclose(got.numpy(), single[name], rtol=1e-12,
                               atol=1e-12 * np.abs(single[name]).max())
    with pytest.raises(ValueError, match="no process group"):
        make_mesh(4, device="cpu")


def test_backend_rule():
    """gloo on the CPU, never NCCL; the card's rule is NCCL only with a
    card per rank (checked on the card by chip_smoke.py)."""
    assert launch.choose_backend("cpu", 4) == "gloo"
    with pytest.raises(ValueError, match="only gloo"):
        launch.choose_backend("cpu", 4, "nccl")
    assert launch.ranks_per_card("cpu", 4) is None
    with pytest.raises(RuntimeError, match="cuda"):
        launch.run_ranks(torch_dist_ranks.failing_rank, 2, device="cuda",
                         bad_rank=0, hang=False)


def test_backend_rule_counts_this_hosts_ranks(monkeypatch):
    """The card's rule counts the ranks of this host against its cards: two
    hosts of four cards with eight ranks give each rank a card (NCCL, one
    rank a card), eight ranks on one such host share (gloo, two a card)."""
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.delenv("LOCAL_WORLD_SIZE", raising=False)
    assert launch.local_world_size(8) == 8
    assert launch.local_world_size(8, 4) == 4
    monkeypatch.setenv("LOCAL_WORLD_SIZE", "4")
    local = launch.local_world_size(8)
    assert local == 4
    assert launch.choose_backend("cuda", local) == "nccl"
    assert launch.choose_backend("cuda", local, "nccl") == "nccl"
    assert launch.ranks_per_card("cuda", local) == 1
    assert launch.choose_backend("cuda", 8) == "gloo"
    assert launch.ranks_per_card("cuda", 8) == 2
    with pytest.raises(ValueError, match="card per rank"):
        launch.choose_backend("cuda", 8, "nccl")


@pytest.mark.parametrize("hang", (False, True))
def test_failed_rank_fails_the_launch(monkeypatch, hang):
    """A rank that raises, or hangs past the launcher's limit, ends every
    rank and raises in the launching process; nothing waits forever.  Only
    the hang gets a short limit: a raising rank must be reported as such
    however slowly the ranks start on a loaded host."""
    limit = 10 if hang else launch.RANK_LIMIT_S
    monkeypatch.setattr(launch, "RANK_LIMIT_S", limit)
    t0 = time.monotonic()
    with pytest.raises(TimeoutError if hang else RuntimeError,
                       match="did not finish" if hang else "on purpose"):
        launch.run_ranks(torch_dist_ranks.failing_rank, 2, device="cpu",
                         bad_rank=1, hang=hang)
    assert time.monotonic() - t0 < (limit if hang else 0) + 120


def test_partition_config_matches_jax():
    """`config.PartitionConfig`: the JAX dataclass's fields and defaults,
    and the mesh's axis name."""
    import dataclasses

    fields = lambda cls: [(f.name, f.default)
                          for f in dataclasses.fields(cls)]
    assert fields(ht.PartitionConfig) == fields(JPartitionConfig)
    assert make_mesh(device="cpu").axis_name == \
        ht.PartitionConfig().axis_name
