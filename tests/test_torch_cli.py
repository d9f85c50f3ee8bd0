"""The port's command-line interface (`python -m helmholtz_tpu_torch`)
against the JAX package's on the same arguments, and the JAX CLI tests'
assertions (tests/test_aux.py) on the port alone, on the CPU."""
import json
import os
import subprocess
import sys

import pytest
import torch

from helmholtz_tpu.cli import main as jax_cli
from helmholtz_tpu_torch.cli import main as cli
from helmholtz_tpu_torch.utils.checkpoint import load_report_arrays

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = ["--n", "31", "--b", "8", "--wave-num", "2", "--const", "30"]


def test_solve_matches_jax_cli(tmp_path, capsys):
    met_t, met_j = tmp_path / "t.jsonl", tmp_path / "j.jsonl"
    rc_t = cli(["solve", "--device", "cpu", *SMALL, "--metrics", str(met_t)])
    out_t = capsys.readouterr().out
    rc_j = jax_cli(["solve", *SMALL, "--metrics", str(met_j)])
    out_j = capsys.readouterr().out
    line = lambda out: next(l for l in out.splitlines()
                            if l.startswith("GMRES iterations"))
    assert rc_t == rc_j == 0
    assert line(out_t) == line(out_j)
    rt = json.loads(met_t.read_text())
    rj = json.loads(met_j.read_text())
    assert (rt["iterations"], rt["converged"]) == \
        (rj["iterations"], rj["converged"])


def test_cli_solve_with_artifacts(tmp_path, capsys):
    png, rpng = tmp_path / "u.png", tmp_path / "res.png"
    met, npz = tmp_path / "m.jsonl", tmp_path / "sol.npz"
    rc = cli(["solve", "--device", "cpu", *SMALL, "--plot", str(png),
              "--plot-residuals", str(rpng), "--metrics", str(met),
              "--save", str(npz)])
    out = capsys.readouterr().out
    assert rc == 0
    assert "GMRES iterations with preconditioner:" in out
    assert png.exists() and rpng.exists()
    rec = json.loads(met.read_text().strip())
    assert rec["converged"] and rec["iterations"] <= 6
    assert rec["device"] == "cpu"
    u, hist, meta = load_report_arrays(str(npz))
    assert u.shape == (31, 31) and meta["n"] == 31


def test_cli_bicgstab_and_fidelity_flags():
    rc = cli(["solve", "--device", "cpu", *SMALL, "--method", "bicgstab",
              "--quiet"])
    assert rc == 0
    # as-shipped D3: converges but slowly -> still exit 0 with maxiter room
    rc = cli(["solve", "--device", "cpu", *SMALL, "--block-diag-hf",
              "--maxiter", "200", "--quiet"])
    assert rc == 0


def test_cli_multisolve_amortized_checkpoint_resume(tmp_path):
    """The amortized sweep's resume re-runs the WHOLE sweep as a unit and
    emits only the missing records."""
    ck = tmp_path / "sweep.jsonl"
    args = ["multisolve", "--device", "cpu", "--n", "63", "--b", "12",
            "--freqs", "4.0", "4.1", "4.2", "--consts", "61.0",
            "--multi-rhs", "1", "--factor-stride", "4", "--g-compress",
            "--freq-anchor-every", "2", "--checkpoint", str(ck)]
    assert cli(args) == 0
    recs = [json.loads(l) for l in ck.read_text().splitlines()]
    assert sorted(r["wave_num"] for r in recs) == [4.0, 4.1, 4.2]
    keep = [r for r in recs if r["wave_num"] != 4.1]
    ck.write_text("".join(json.dumps(r) + "\n" for r in keep))
    assert cli(args) == 0
    recs2 = [json.loads(l) for l in ck.read_text().splitlines()]
    assert len(recs2) == 3
    assert sorted(r["wave_num"] for r in recs2) == [4.0, 4.1, 4.2]
    again = [r for r in recs2 if r["wave_num"] == 4.1]
    assert again[0]["setup_mode"] == "omega_lerp"


def test_cli_save_precond_and_profile(tmp_path):
    from helmholtz_tpu_torch.utils.checkpoint import load_preconditioner

    npz, trace = tmp_path / "P.npz", tmp_path / "trace"
    assert cli(["solve", "--device", "cpu", "--n", "15", "--b", "4",
                "--wave-num", "1", "--const", "20", "--quiet",
                "--save-precond", str(npz), "--profile", str(trace)]) == 0
    P = load_preconditioner(str(npz), device="cpu")
    assert P.b == 4 and P.G_re.shape[:2] == (11, 15)
    assert (trace / "trace.json").exists()


def test_cli_plan_json(capsys):
    assert cli(["plan", "--n", "2047", "--stencil", "9pt", "--g-dtype",
                "bf16", "--device", "cpu"]) == 0
    p = json.loads(capsys.readouterr().out)
    assert p["n"] == 2047 and p["b"] == 147 and p["hbm_gb"] == 80.0
    assert p["fits_single_chip"] and p["g_panels_stored"] == 239
    assert cli(["plan", "--n", "1023", "--batch", "4", "--device",
                "cpu"]) == 0
    p = json.loads(capsys.readouterr().out)
    assert p["batch"] == 4 and p["g_blocks_stored"] == 1011


def test_plan9_matches_measured_flagship():
    """tests/test_aux.py's plan9 assertions on the port: n = 2047 compressed
    bf16 fits with about 4.0 GB of sample panels; at the JAX package's
    16 GB n = 3071 does not fit (the 80 GB card holds it)."""
    from helmholtz_tpu_torch.bench.plan import plan9

    p = plan9(2047)
    assert p["b"] == 147
    assert p["fits_single_chip"]
    assert abs(p["g_stack_gb"] - 4.0) < 0.3
    assert "hostloop_envelope" not in p
    assert not plan9(3071, hbm_gb=16.0)["fits_single_chip"]
    assert not plan9(2047, hbm_gb=16.0)["fits_single_chip"]


@pytest.mark.parametrize("argv", (
    ["bench-scaling", "--device", "cpu", "--n", "32", "--b", "3",
     "--ndevs", "2"],
    ["multisolve", "--device", "cpu", "--n", "32", "--b", "3", "--freqs",
     "2.0", "--consts", "20", "--multi-rhs", "2", "--mesh", "4"]))
def test_distributed_commands_name_item_16(argv, capsys):
    """The distributed path's commands (once stubs that raised)
    run: `bench-scaling` prints its record, labelled as CPU ranks that are
    no scaling numbers; `multisolve --mesh 4` its converged records."""
    assert cli(argv) == 0
    out = capsys.readouterr().out
    if argv[0] == "bench-scaling":
        rep = json.loads(out)
        assert rep["backend"] == "cpu-gloo" and not rep["scaling_numbers"]
        assert [r["n_devices"] for r in rep["strong"]] == [2]
    else:
        rec = json.loads(out.strip().splitlines()[-1])
        assert rec["mesh_devices"] == 4 and all(rec["converged"])


@pytest.mark.parametrize("argv", (
    ["solve", "--method", "gmres-hostloop"],
    ["solve", "--schur-block", "2"],
    ["bench-spmv", "--pallas"]))
def test_workaround_flags_are_refused(argv, capsys):
    with pytest.raises(SystemExit) as e:
        cli(argv)
    assert e.value.code == 2


def test_default_device_needs_the_card():
    if torch.cuda.is_available():
        return
    with pytest.raises(RuntimeError, match="device='cuda'"):
        cli(["solve", *SMALL, "--quiet"])


def test_help_imports_no_jax():
    probe = (
        "import runpy, sys, json\n"
        "sys.argv = ['helmholtz_tpu_torch', '--help']\n"
        "try:\n"
        "    runpy.run_module('helmholtz_tpu_torch', run_name='__main__')\n"
        "except SystemExit as e:\n"
        "    code = e.code\n"
        "import torch\n"
        "print(json.dumps({'code': code, 'jax': 'jax' in sys.modules,\n"
        "    'matplotlib': 'matplotlib' in sys.modules,\n"
        "    'cuda_initialized': torch.cuda.is_initialized()}))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "Not ported" in out.stdout
    rec = json.loads(out.stdout.strip().splitlines()[-1])
    assert rec == {"code": 0, "jax": False, "matplotlib": False,
                   "cuda_initialized": False}
    rc = subprocess.run([sys.executable, "-m", "helmholtz_tpu_torch",
                         "--help"], cwd=ROOT, env=env, capture_output=True,
                        timeout=120).returncode
    assert rc == 0
