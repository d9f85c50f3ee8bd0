"""The port's auxiliary subsystems on the CPU, after the JAX package's
`tests/test_aux.py`: checkpoints of factored state (round trip, files moving
both ways between the packages, the round-3 compressed layout), resumable
GMRES, the sweep checkpoint, reports, metrics logging, plots and profiling
phases, and `config.PrecisionConfig`."""
import dataclasses
import json
import os
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import torch

import helmholtz_tpu as hj
import helmholtz_tpu_torch as ht
from helmholtz_tpu import driver as jdriver
from helmholtz_tpu.core.complexlib import complexify
from helmholtz_tpu.precond import sweeping as jsweep
from helmholtz_tpu.utils import checkpoint as jcheckpoint
from helmholtz_tpu_torch.fd import stencil as fd_stencil
from helmholtz_tpu_torch.precond import sweeping as tsweep
from helmholtz_tpu_torch.solve.resumable import (SweepCheckpoint,
                                                 load_krylov_state,
                                                 resumable_gmres)
from helmholtz_tpu_torch.utils import checkpoint as tcheckpoint
from helmholtz_tpu_torch.utils import profiling
from helmholtz_tpu_torch.utils.logging import GmresCounter, log_metrics

from torch_parity import to_np


def _same_state(P, Q):
    for f in dataclasses.fields(P):
        a, b = getattr(P, f.name), getattr(Q, f.name)
        if isinstance(a, torch.Tensor):
            assert a.dtype == b.dtype and torch.equal(a, b), f.name
        else:
            assert a == b, f.name


def test_precond_checkpoint_roundtrip(tmp_path):
    """`build_preconditioner`, saved and loaded: equal tensors and equal
    applies; a compressed bfloat16 stack keeps its type and tables."""
    P, A, f = ht.build_preconditioner(31, 8, 2.0, 30.0, device="cpu")
    path = tcheckpoint.save_preconditioner(str(tmp_path / "P.npz"), P)
    P2 = tcheckpoint.load_preconditioner(path, device="cpu")
    _same_state(P, P2)
    v = f.reshape(-1)
    assert torch.equal(P(v), P2(v))
    r1 = ht.gmres(lambda x: ht.stencil_matvec_flat(A, x), v, M=P,
                  device="cpu")
    r2 = ht.gmres(lambda x: ht.stencil_matvec_flat(A, x), v, M=P2,
                  device="cpu")
    assert r1.iterations == r2.iterations and torch.equal(r1.x, r2.x)
    cfg = ht.HelmholtzConfig(n=31, b=8, wave_num=2.0, const=30.0)
    prob = ht.assemble_problem(cfg, complex_dtype=torch.complex64,
                               device="cpu")
    hm = fd_stencil.build_hm_stencils(
        31, 8, cfg.const, cfg.eta, cfg.omega, cfg.h, prob.c_full,
        fidelity="corrected", complex_dtype=torch.complex64)
    Pc = tsweep.setup_preconditioner(prob.A, hm, 8, g_dtype=torch.bfloat16,
                                     factor_stride=4, g_compress=True,
                                     device="cpu")
    path = tcheckpoint.save_preconditioner(str(tmp_path / "Pc.npz"), Pc)
    assert json.loads(bytes(np.load(path)["_meta"]).decode())["g_dtype"] \
        == "bf16"
    _same_state(Pc, tcheckpoint.load_preconditioner(path, device="cpu"))


def test_precond_checkpoint_moves_between_packages(tmp_path):
    """A file the JAX package's `save_preconditioner` wrote loads in the
    port and applies within 1e-12 of the JAX apply; a file the port wrote
    loads in the JAX package and applies within 1e-12 of the port's."""
    P_j, _, f_j = jdriver.build_preconditioner(31, 8, 2.0, 30.0)
    f = np.array(complexify(f_j)).reshape(31, 31)
    ref = np.asarray(jsweep.apply_preconditioner(P_j, jnp.asarray(f)))
    path = jcheckpoint.save_preconditioner(str(tmp_path / "jax.npz"), P_j)
    P_t = tcheckpoint.load_preconditioner(path, device="cpu")
    got = to_np(tsweep.apply_preconditioner(P_t, torch.from_numpy(f)))
    assert np.linalg.norm(got - ref) / np.linalg.norm(ref) < 1e-12

    path = tcheckpoint.save_preconditioner(str(tmp_path / "port.npz"), P_t)
    P_back = jcheckpoint.load_preconditioner(path)
    assert P_back.G.re.shape == (23, 31, 31) and P_back.b == 8
    back = np.asarray(jsweep.apply_preconditioner(P_back, jnp.asarray(f)))
    assert np.linalg.norm(back - got) / np.linalg.norm(got) < 1e-12


def test_precond_checkpoint_loads_round3_compressed_format(tmp_path):
    """The round-3 layout (1-D g_w holding t, no g_lo) loads: the tables
    are static given (M, stride) and are rebuilt by `compress_tables`."""
    cfg = ht.HelmholtzConfig(n=63, b=12, wave_num=4.0, const=61.0)
    prob = ht.assemble_problem(cfg, device="cpu")
    hm = fd_stencil.build_hm_stencils(
        63, 12, cfg.const, cfg.eta, cfg.omega, cfg.h, prob.c_full,
        fidelity="corrected")
    P = tsweep.setup_preconditioner(prob.A, hm, 12, factor_stride=4,
                                    g_compress=True, device="cpu")
    path = tcheckpoint.save_preconditioner(str(tmp_path / "P.npz"), P)
    z = dict(np.load(path))
    z["g_w"] = np.asarray(z["g_w"])[:, 1]
    del z["g_lo"]
    np.savez_compressed(path, **z)
    P2 = tcheckpoint.load_preconditioner(path, device="cpu")
    g_w, g_lo = tsweep.compress_tables(63 - 12, 4)
    np.testing.assert_array_equal(to_np(P2.g_w), g_w)
    np.testing.assert_array_equal(to_np(P2.g_lo), g_lo)
    assert torch.equal(P2.G_re, P.G_re)


def test_resumable_gmres_kill_and_resume_matches_uninterrupted(tmp_path):
    """Killed after one restart cycle, resumed in a fresh call: the same
    count and the same bits as one uninterrupted run."""
    cfg = ht.HelmholtzConfig(n=31, b=5, wave_num=2.0, const=20.0)
    prob = ht.assemble_problem(cfg, device="cpu")
    hm = fd_stencil.build_hm_stencils(
        31, 5, cfg.const, cfg.eta, cfg.omega, cfg.h, prob.c_full,
        fidelity="corrected")
    P = tsweep.setup_preconditioner(prob.A, hm, 5, device="cpu")
    mv = lambda v: ht.stencil_matvec_flat(prob.A, v)          # noqa: E731
    b = prob.f_vec
    ref = ht.gmres(mv, b, M=P, restart=3, rtol=1e-10, maxiter=30,
                   device="cpu")
    assert ref.converged and ref.iterations > 3
    path = str(tmp_path / "krylov.npz")
    part = resumable_gmres(mv, b, M=P, checkpoint_path=path, restart=3,
                           rtol=1e-10, maxiter=3, device="cpu")
    assert not part.converged
    assert load_krylov_state(path)[1] == 3
    full = resumable_gmres(mv, b, M=P, checkpoint_path=path, restart=3,
                           rtol=1e-10, maxiter=30, device="cpu")
    assert full.converged and full.iterations == ref.iterations
    assert torch.equal(full.x, ref.x)
    h_ref = ref.history[~np.isnan(ref.history)][:ref.iterations]
    np.testing.assert_array_equal(full.history, h_ref)


def test_sweep_checkpoint_records_and_skips(tmp_path):
    path = str(tmp_path / "sweep.jsonl")
    ck = SweepCheckpoint(path)
    assert ck.done_keys() == set()
    rec = {**ht.driver.multisolve_key_config(63, 12, "c1_f1", 1e-3, 2,
                                             device="cpu"),
           "wave_num": 8.0, "const": 61.0, "converged": [True]}
    ck.add(rec)
    ck2 = SweepCheckpoint(path)
    assert ck2.done_keys() == {SweepCheckpoint.key_of(rec)}
    assert ck2.records[0]["converged"] == [True]
    assert SweepCheckpoint.key_of({**rec, "rtol": 1e-6}) \
        not in ck2.done_keys()
    assert ck2.matching({**rec, "n_sources": 8}) == []
    assert ck2.matching({**rec, "precond": "recompute"}) == []
    assert len(ck2.matching(rec)) == 1


def test_report_metrics_plots_and_counter(tmp_path, capsys):
    """`save_report` / `load_report_arrays`, `log_metrics` to a file,
    `run_solver(plot_solution=True)` and the three plots under the Agg
    backend, and `GmresCounter.replay`."""
    rep = ht.run_solver(31, 8, 2.0, 30.0, device="cpu",
                        plot_solution=True)
    path = tcheckpoint.save_report(str(tmp_path / "sol.npz"), rep)
    u, hist, meta = tcheckpoint.load_report_arrays(path)
    np.testing.assert_array_equal(u, rep.u)
    np.testing.assert_array_equal(hist, rep.history)
    assert meta["n"] == 31 and meta["iterations"] == rep.iterations
    log = tmp_path / "m.jsonl"
    log_metrics(rep, str(log), extra={"tag": "x"})
    line = json.loads(log.read_text().strip())
    assert line["converged"] and line["tag"] == "x"
    from helmholtz_tpu_torch import viz
    for fn, name in ((viz.plot_solution, "u.png"),
                     (viz.plot_residual_history, "r.png")):
        out = fn(rep, str(tmp_path / name))
        assert os.path.getsize(out) > 1000
    out = viz.plot_runtime([0.1, 0.2], [0.3, 0.5], [31, 63],
                           str(tmp_path / "t.png"))
    assert os.path.getsize(out) > 1000
    c = GmresCounter(disp=True)
    c.replay([1e-1, 1e-3, float("nan")])
    assert c.niter == 2 and "iter   1" in capsys.readouterr().out


def test_profiling_phases_in_trace(tmp_path):
    """A CPU solve inside `profiling.trace`: the exported trace holds the
    driver's assemble, factor and solve phases."""
    with profiling.trace(str(tmp_path)):
        ht.run_solver(15, 4, 1.0, 20.0, device="cpu")
    names = {e.get("name") for e in json.loads(
        (tmp_path / "trace.json").read_text())["traceEvents"]}
    assert {"assemble", "factor", "solve"} <= names


def test_package_imports_without_matplotlib():
    """matplotlib is imported only when a plot is made."""
    code = ("import sys; sys.modules['matplotlib'] = None; "
            "import helmholtz_tpu_torch, helmholtz_tpu_torch.viz")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(os.path.dirname(__file__)))


def test_precision_config_matches_jax():
    for cd in ("complex64", "complex128"):
        ref, got = hj.PrecisionConfig(cd), ht.PrecisionConfig(cd)
        assert dataclasses.asdict(got) == dataclasses.asdict(ref)
        assert got.real_dtype == ref.real_dtype


def test_bf16_plane_written_by_numpy_void_loads(tmp_path):
    """A bfloat16 G plane that numpy holds as 2-byte records (how a JAX
    bfloat16 array comes back from an .npz) loads as bfloat16."""
    P, _, _ = ht.build_preconditioner(15, 4, 1.0, 20.0, device="cpu")
    path = tcheckpoint.save_preconditioner(str(tmp_path / "P.npz"), P)
    z = dict(np.load(path))
    for k in ("G_re", "G_im"):
        bits = torch.from_numpy(z[k].astype(np.float32)).to(
            torch.bfloat16).view(torch.int16).numpy()
        z[k] = bits.view("V2")
    meta = json.loads(bytes(z["_meta"]).decode())
    del meta["g_dtype"]
    z["_meta"] = np.frombuffer(json.dumps(meta).encode(), np.uint8)
    np.savez(path, **z)
    P2 = tcheckpoint.load_preconditioner(path, device="cpu")
    assert P2.G_re.dtype == torch.bfloat16
    assert torch.equal(P2.G_re, P.G_re.to(torch.bfloat16))
