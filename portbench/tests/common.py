"""Tiny CPU stand-ins for the cells, shared by the benchmark's tests."""
import json
import pathlib

ROOT = pathlib.Path(__file__).resolve().parents[2]


def bench() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def tiny_config(name="c1_f1-n1023", n=63, **over) -> dict:
    cfg = json.loads((ROOT / "portbench" / "configs"
                      / f"{name}.json").read_text())
    cfg.update({"n": n, "factor_stride": min(cfg["factor_stride"], 2),
                **over})
    return cfg


def tiny_mix(name="gather64", k=4, band=(7.0, 8.0), **over) -> dict:
    import traffic
    mix = traffic.load(name)
    mix.update(sources_per_request=k, band=list(band), **over)
    return mix
