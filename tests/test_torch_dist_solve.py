"""The port's distributed solve and distributed multisolve against the JAX
package's on the CPU, in complex128.

The JAX side runs `distributed_solve` (batched, ir-df32, with a
preconditioner refinement) and `run_multisolve(mesh_devices=4)` (amortized
on both stencils, refined) on `make_mesh(4)`; the port runs four gloo
ranks (one spawn for the module, `torch_dist_ranks.solve_cases`, while the
JAX side computes), the solves on the bands of the same JAX distributed
state (`convert.dist_state_from_numpy`).  Equal iteration counts,
solutions to 1e-8.  Then the command line's
`multisolve --mesh 2`, two processes joined by
`dist.multihost.initialize`, and the dry run (`dist.dryrun`) at n = 32."""
import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import helmholtz_tpu_torch as ht
from helmholtz_tpu import driver as jdriver
from helmholtz_tpu.dist import dist_state_from_preconditioner
from helmholtz_tpu.dist import distributed_solve as j_solve
from helmholtz_tpu.dist import make_mesh as j_make_mesh
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu_torch.cli import main as cli
from helmholtz_tpu_torch.dist import launch

import torch_dist_ranks
from torch_parity import port_problems, random_grid, to_np  # noqa: F401

NDEV = 4
N, B = 32, 3
SOLVES = (("batched", dict(rtol=1e-6)),
          ("ir_df32", dict(rtol=1e-10, precision="ir-df32")),
          ("refine", dict(rtol=1e-6, precond_refine=1)))
AMORTIZED = dict(consts=[20.0], n_sources=2, factor_stride=3,
                 g_compress=True, freq_anchor_every=2)
MULTI = (("amortized", (N, B, [2.1, 2.0, 2.05]), AMORTIZED),
         ("nine_amortized", (N, B, [2.1, 2.0, 2.05]),
          dict(AMORTIZED, stencil="9pt")),
         ("refine", (N, B, [2.0]),
          dict(consts=[20.0], n_sources=2, precond_refine=1)))


@pytest.fixture(scope="module")
def sides():
    _, jprob, jhm, tprob, _ = port_problems(N, B, 2.0, 20.0)
    Pj = jsweep.setup_preconditioner(jprob.A, jhm, B)
    S = dist_state_from_preconditioner(Pj)
    state = dict(nine=False, g_dtype=None, G_re=np.asarray(S.G_pad.re),
                 G_im=np.asarray(S.G_pad.im), TF=S.TF.to_np(), b=B,
                 d2_replace=True, n=N, **{k: getattr(S, k).to_np() for k in
                                          ("hf_cs", "hf_cn", "a_cs", "a_cn")})
    f = to_np(tprob.f_grid)
    F2 = np.stack([f, random_grid(3, (N, N))])
    fields = [to_np(t) for t in tprob.A.fields()]
    cases = [(name, state, fields, F2 if name == "batched" else f, kw)
             for name, kw in SOLVES]
    # the ranks (one thread each) run while this process computes the JAX
    # side: the two overlap, and the file takes the longer of the two
    with ThreadPoolExecutor(1) as pool:
        ranks = pool.submit(
            launch.run_ranks, torch_dist_ranks.solve_cases, NDEV,
            device="cpu", cases=cases, multisolves=MULTI, dryrun_n=N)
        mesh = j_make_mesh(NDEV)
        jax_out = {}
        for name, _, _, F, kw in cases:
            res = j_solve(mesh, jprob.A, S, jnp.asarray(F), **kw)
            jax_out[name] = (np.asarray(res.iterations).tolist(),
                             res.x.to_np().reshape(F.shape))
        for name, args, kw in MULTI:
            jax_out["multi_" + name] = jdriver.run_multisolve(
                *args, mesh_devices=NDEV, **kw)
        return jax_out, ranks.result()


@pytest.mark.parametrize("name", [s[0] for s in SOLVES])
def test_distributed_solve_matches_jax(sides, name):
    """A batch of two, the complex128 refinement to rtol 1e-10, and one
    Newton refinement of the preconditioner: the JAX package's counts, its
    solutions to 1e-8."""
    jax_out, ranks = sides
    its, x_ref = jax_out[name]
    got = ranks[name]
    assert got["iterations"] == its
    assert np.all(got["converged"])
    np.testing.assert_allclose(got["x"], x_ref, rtol=1e-8,
                               atol=1e-8 * np.abs(x_ref).max())


@pytest.mark.parametrize("name", [m[0] for m in MULTI])
def test_run_multisolve_mesh_matches_jax(sides, name):
    """run_multisolve(mesh_devices=4) against the JAX package's mesh run:
    amortized over compressed G on both stencils (factor, factor,
    omega_lerp), and with a preconditioner refinement.  The counts, setup
    modes and true residuals, and the distributed path's own keys."""
    jax_out, ranks = sides
    for got, ref in zip(ranks["multi_" + name], jax_out["multi_" + name],
                        strict=True):
        assert got["iterations"] == ref["iterations"]
        assert got.get("setup_mode") == ref.get("setup_mode")
        np.testing.assert_allclose(got["true_residuals"],
                                   ref["true_residuals"], rtol=1e-6)
        assert got["mesh_devices"] == NDEV
        assert ref["mesh_devices"] == NDEV
        assert got["per_device_g_bytes"] > 0
        assert got["dist_backend"] == "gloo"
        assert got["ranks_per_card"] is None
        assert len(got["rank_launches"]) == NDEV
        for c in got["rank_launches"]:
            # the CPU launches no kernel; every rank made the same applies
            assert c["apply_chunks"] == got["rank_launches"][0][
                "apply_chunks"] > 0
            assert c["sweep"] == c["stencil_matvec"] == c["gj_inverse"] == 0


def test_dryrun_on_ranks(sides):
    """The dry run's four legs at n = 32 (n_loc = 8): its own checks
    passed; the counts are the single-card ones within one."""
    _, ranks = sides
    out = ranks["dryrun"]
    assert out["n"] == N and out["devices"] == NDEV
    for leg, its in out["iterations"].items():
        ref = out["single_card"][leg]
        assert all(abs(i - ref) <= 1 for i in np.atleast_1d(its)), leg


def test_cli_multisolve_mesh_2(capsys):
    """`multisolve --mesh 2` spawns two ranks and prints the records."""
    rc = cli(["multisolve", "--device", "cpu", "--n", "32", "--b", "3",
              "--freqs", "2.0", "--consts", "20", "--multi-rhs", "2",
              "--mesh", "2"])
    assert rc == 0
    rec = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert rec["mesh_devices"] == 2 and all(rec["converged"])
    [ref] = ht.run_multisolve(32, 3, [2.0], consts=[20.0], n_sources=2,
                              device="cpu")
    assert rec["iterations"] == ref["iterations"]


def test_multihost_initialize_two_processes(tmp_path):
    """Two processes join one group through `multihost.initialize` (a file
    store standing in for a coordinator) and run the distributed multisolve
    in place; both agree with each other and with the single-card run."""
    worker = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "torch_multihost_worker.py")
    store = str(tmp_path / "store")
    procs = [subprocess.Popen(
        [sys.executable, worker, str(r), store, "32", "3"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(2)]
    outs = []
    for p in procs:
        try:
            out, err = p.communicate(timeout=300)
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            pytest.fail("multihost workers timed out")
        assert p.returncode == 0, err[-3000:]
        outs.append(json.loads(out.strip().splitlines()[-1]))
    assert [o["process_index"] for o in outs] == [0, 1]
    assert all(o["processes"] == o["global_devices"] == 2 for o in outs)
    assert [o["mesh"] for o in outs] == [[2, 0], [2, 1]]
    assert outs[0]["iterations"] == outs[1]["iterations"]
    [ref] = ht.run_multisolve(32, 3, [2.0], consts=[20.0], n_sources=2,
                              device="cpu")
    assert outs[0]["iterations"] == ref["iterations"]
    assert all(outs[0]["converged"])
