"""Every configuration, mix, limit and metric of BENCHMARK.json loads by
name, and the file keeps the contract's shapes."""
import json
import re

import pytest

import check
import harness
import traffic
from common import ROOT, bench

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_benchmark_json_shapes():
    b = bench()
    assert set(b) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert b["paths"] == ["portbench"]
    assert 1 <= b["run_seconds"] <= 51
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in b[k]]
    assert len(names) == len(set(names))
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in b["end_to_end"]}
    assert "setup_s" in e2e
    for m in b["end_to_end"] + b["per_layer"]:
        assert UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    for m in b["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")
    for m in b["per_layer"]:
        assert m["moves"] in e2e
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
    pairs = [(w["config"], w["traffic"]) for w in b["workloads"]]
    assert len(pairs) == len(set(pairs))
    assert len(json.dumps(b)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in bench()["workloads"]])
def test_cell_files_load_by_name(cell):
    b = bench()
    w = {x["name"]: x for x in b["workloads"]}[cell]
    c = {x["name"]: x for x in b["configs"]}[w["config"]]
    assert c["file"].startswith("portbench/configs/")
    cfg = json.loads((ROOT / c["file"]).read_text())
    for key in ("problem", "medium", "forcing", "n", "b", "const", "alpha",
                "fidelity", "complex_dtype", "tf32", "g_dtype",
                "factor_stride", "g_compress", "k2_mode"):
        assert key in cfg, key
    mix = traffic.load(w["traffic"])
    for key in ("sources_per_request", "band", "x_range",
                "y", "rtol", "restart", "maxiter", "check_requests"):
        assert key in mix, key
    lim = check.load_limits(cell)
    assert 0 < lim["max_true_residual"] < 1
    assert w["chips"] == 1


@pytest.mark.parametrize("name", [m["name"] for m in bench()["end_to_end"]
                                  + bench()["per_layer"]])
def test_metric_reader_loads_and_finds_nothing_in_an_empty_run(name):
    run = harness.RunData(config={}, mix={}, setup_s=1.0, window_s=0.0,
                          attempted=0, failed=0, peak_bytes=0, requests=[],
                          spans=[], applies=[], trace=None, launches={})
    value = harness.read_metric(name, run)
    assert value is None or name == "setup_s"


def test_requests_depend_on_seed_and_index_only():
    mix = traffic.load("gather64")
    seed = 2 ** 31 + 12345
    a = [traffic.request(mix, seed, i) for i in range(10)]
    assert traffic.request(mix, seed, 7) == a[7]
    assert a != [traffic.request(mix, seed + 1, i) for i in range(10)]
    lo, hi = mix["band"]
    assert all(lo <= r.wave_num <= hi for r in a)
    # every run of 2^m requests holds one frequency in each 2^-m of the
    # band, whatever the seed
    for m in (1, 2, 3):
        cells = sorted(int((r.wave_num - lo) / (hi - lo) * 2 ** m) % 2 ** m
                       for r in a[:2 ** m])
        assert len(set(cells)) == 2 ** m
    assert len(a[0].xs) == mix["sources_per_request"]
    assert [traffic.radical_inverse(i, 2) for i in range(4)] == [
        0, 0.5, 0.25, 0.75]
    one = traffic.load("sweep1")
    r = traffic.request(one, seed, 3)
    assert len(r.xs) == 1 and abs(r.xs[0] - 0.5) <= 0.05 + 1e-12
