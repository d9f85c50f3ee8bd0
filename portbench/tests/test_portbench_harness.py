"""The harness on the CPU at a tiny size: the entry, a whole run, the
command's refusal without a card, the control and the faults that the check
must catch (each with the program's timed path broken underneath)."""
import dataclasses
import json
import subprocess
import sys
import time

import numpy as np
import pytest
import torch

import check
import control
import entry
import harness
import traffic
from common import ROOT, bench, tiny_config, tiny_mix
from helmholtz_tpu_torch.ops.kernels.spmv_stencil import stencil_matvec_flat

LIMITS = {"max_true_residual": 3e-3}


def run(gather=entry.gather, cfg=None, mix=None, limits=LIMITS, seconds=1.0,
        seed=2 ** 31 + 77):
    return harness.run_cell(
        {"chips": 1}, cfg or tiny_config(), mix or tiny_mix(), limits,
        seed=seed, seconds=seconds, trace=False,
        metric_defs=bench()["end_to_end"], device="cpu",
        t_start=time.perf_counter(), gather=gather)


def test_entry_runs_one_request_on_the_cpu():
    cfg, mix = tiny_config(), tiny_mix()
    req = traffic.request(mix, 5, 0)
    applies = []
    out = entry.gather(cfg, req.wave_num, req.xs, req.ys, device="cpu",
                       rtol=1e-3, restart=20, maxiter=60, applies=applies)
    assert out.x.shape == (4, 63 * 63) and out.converged.all()
    assert len(applies) >= out.iterations.max() and applies[0].width == 4
    assert not applies[0].shared and applies[0].rows == 63 - 12
    r = check.residuals(cfg, req, out.x.numpy())
    assert max(r) < 1e-3


def test_entry_shares_one_panel_for_the_row_invariant_medium():
    cfg = tiny_config("c2_f1-n2047", n=63)
    mix = tiny_mix("gather16", band=(7.0, 8.0))
    req = traffic.request(mix, 5, 0)
    applies = []
    out = entry.gather(cfg, req.wave_num, req.xs, req.ys, device="cpu",
                       rtol=1e-3, restart=20, maxiter=60, applies=applies)
    assert applies[0].shared and applies[0].planes == 1
    assert max(check.residuals(cfg, req, out.x.numpy())) < 1e-3


def test_a_whole_run_is_correct():
    r = run()
    assert r["correct"] and r["failed"] == 0 and r["attempted"] >= 4
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics",
                           "device"]
    assert list(r)[-1] == "check"
    assert set(r["metrics"]) == {"rhs_per_s", "setup_s"}   # no peak on CPU
    assert r["check"]["worst_true_residual"]["value"] < 1e-3
    assert r["setup_build_s"] == 0.0 and r["iters_per_rhs"] >= 1
    json.dumps(r)


def test_the_command_refuses_without_a_card():
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload",
         bench()["workloads"][0]["name"], "--seed", str(2 ** 31 + 1),
         "--seconds", "1", "--trace", "0"], cwd=ROOT, capture_output=True,
        text=True, timeout=120)
    assert out.returncode != 0 and out.stdout.strip() == ""


def broken(fault):
    def gather(cfg, wave_num, xs, ys, **kw):
        out = entry.gather(cfg, wave_num, xs, ys, **kw)
        x = out.x.clone()
        if fault == "state_unchanged":        # the solve returns x0 = 0
            x.zero_()
        elif fault == "half_batch":           # half the sources not solved
            x[len(xs) // 2:] = 0
        elif fault == "answer_altered":       # two answers exchanged
            x[[0, 1]] = x[[1, 0]]
        return dataclasses.replace(out, x=x)
    return gather


@pytest.mark.parametrize("fault", ["state_unchanged", "half_batch",
                                   "answer_altered"])
def test_each_fault_comes_out_not_correct(fault):
    r = run(broken(fault))
    assert r["correct"] is False
    assert r["check"]["worst_true_residual"]["value"] > 0.1


def test_unconverged_comes_out_not_correct():
    r = run(mix=tiny_mix(maxiter=1))
    assert r["correct"] is False and r["failed"] > 0


def test_a_sweep_in_another_g_layout_comes_out_not_correct(monkeypatch):
    """The configuration states the sweep kernel's G layout (`k2_mode`); a
    window that launches it in another one is no sound run."""
    assert run()["check"]["k2_other_mode_launches"]["value"] == 0
    monkeypatch.setattr(harness, "_launch_counts", lambda: {
        "k1": 10, "k2": {"fwd.R4.dense": 6, "fwd.R4.lerp": 2}, "k3": 0})
    r = run()
    assert r["correct"] is False
    assert r["check"]["k2_other_mode_launches"] == {"value": 2, "limit": 0}


def test_the_control_reads_the_program_and_its_tf32_path():
    """On the CPU TF32 does not exist, so both read alike; on the card the
    control must come out not correct (`test_the_control_fails_on_the_card`)."""
    mix = tiny_mix(check_requests=2)
    out = control.readings({"chips": 1}, tiny_config(), mix, LIMITS,
                           2 ** 31 + 3, device="cpu")
    assert set(out) == {"program", "tf32", "tf32_operator"}
    for r in out.values():
        assert r["requests"] == 2 and r["checked_rhs"] == 2 * 4
        assert r["metrics"]["krylov.iters_per_rhs"]["value"] >= 1
    assert out["program"]["correct"] and out["tf32"]["correct"]
    assert out["tf32_operator"]["correct"] is False
    assert entry.stencil_matvec_flat is stencil_matvec_flat


def test_tf32_rounding_keeps_ten_mantissa_bits():
    x = torch.tensor([1 + 2 ** -11 + 2 ** -20, 3.0 - 1j * (1 + 2 ** -12),
                      -(1 + 2 ** -11 + 2 ** -20)], dtype=torch.complex64)
    y = control.round_tf32(x)
    assert y[0] == 1 + 2 ** -10 and y[1] == 3.0 - 1j
    assert y[2] == -(1 + 2 ** -10)


@pytest.mark.chip
def test_the_control_fails_on_the_card():
    """At n = 255 the program comes out correct and the control, its
    operator product fed TF32, not; the program's own TF32 path is read."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cfg = tiny_config(n=255)
    mix = tiny_mix(k=4, band=(31.0, 32.0), check_requests=1)
    out = control.readings({"chips": 1}, cfg, mix, LIMITS, 2 ** 31 + 21,
                           device="cuda")
    assert out["program"]["correct"], out["program"]["check"]
    assert out["tf32_operator"]["correct"] is False
    assert out["tf32"]["check"]["worst_true_residual"]["value"] > 0


@pytest.mark.chip
def test_one_short_run_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card")
    cell = bench()["workloads"][0]["name"]
    out = subprocess.run(
        [sys.executable, "portbench/run.py", "--workload", cell, "--seed",
         str(2 ** 31 + 9), "--seconds", "2", "--trace", "0"], cwd=ROOT,
        capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1])["correct"]
