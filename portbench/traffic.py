"""The one traffic generator: reads a mix's parameters from
`portbench/traffic/<name>.json` and draws its requests from the seed.

A request is one frequency and a row of sources:

* frequency omega / 2 pi: request i sits at the fraction
  frac(phi + v2(i)) of the band [lo, hi], v2 the base-2 van der Corput
  sequence (0, 1/2, 1/4, 3/4, ...) and phi drawn from the seed;
* sources: `sources_per_request` x positions evenly spaced over `x_range`
  (its midpoint for one source), all shifted by the offset
  j (2 frac(psi + v3(i)) - 1), v3 the base-3 sequence and psi drawn from
  the seed, j = `x_jitter_spacings` times the spacing (for one source, the
  width of `x_range`); every source at height `y`;
* solver settings: `rtol`, `restart`, `maxiter`;
* `check_requests`: how many of a run's requests the check keeps, drawn
  from the seed.

Every prefix of the two sequences spreads evenly over its range whatever
the rotation, so each seed gives other inputs but the same spread of them,
and a window of any length holds the same amount of work up to its last
request; over seeds each request is uniform over the band and the shifts.
Request i depends on (seed, i) alone.  Requests run back to back with one
caller (a closed loop).
"""
from __future__ import annotations

import dataclasses
import json
import pathlib

import numpy as np

DIR = pathlib.Path(__file__).resolve().parent / "traffic"
_WARM, _CHECK = 2 ** 62, 2 ** 62 + 1


@dataclasses.dataclass(frozen=True)
class Request:
    index: int
    wave_num: float
    xs: tuple
    ys: tuple


def load(name: str) -> dict:
    return json.loads((DIR / f"{name}.json").read_text())


def _entropy(seed: int) -> int:
    return int(seed) % 2 ** 64


def radical_inverse(i: int, base: int) -> float:
    """The van der Corput sequence in `base`: i's digits mirrored about
    the radix point."""
    out, scale = 0.0, 1.0 / base
    while i > 0:
        i, digit = divmod(i, base)
        out += digit * scale
        scale /= base
    return out


def _rotations(seed: int, stream: int) -> tuple:
    rng = np.random.default_rng([_entropy(seed), stream])
    return float(rng.uniform()), float(rng.uniform())


def _make(mix: dict, index: int, u_freq: float, u_shift: float) -> Request:
    lo, hi = map(float, mix["band"])
    wave_num = lo + u_freq * (hi - lo)
    k = int(mix["sources_per_request"])
    x0, x1 = map(float, mix["x_range"])
    base = (np.linspace(x0, x1, k) if k > 1
            else np.array([(x0 + x1) / 2.0]))
    spacing = (x1 - x0) / (k - 1) if k > 1 else x1 - x0
    jitter = float(mix["x_jitter_spacings"]) * spacing
    xs = base + (2.0 * u_shift - 1.0) * jitter
    ys = np.full(k, float(mix["y"]))
    return Request(index, float(wave_num), tuple(map(float, xs)),
                   tuple(map(float, ys)))


def request(mix: dict, seed: int, index: int) -> Request:
    phi, psi = _rotations(seed, 0)
    return _make(mix, index, (phi + radical_inverse(index, 2)) % 1.0,
                 (psi + radical_inverse(index, 3)) % 1.0)


def warmup_request(mix: dict, seed: int) -> Request:
    """A request at the cell's shapes, apart from the window's."""
    return _make(mix, -1, *_rotations(seed, _WARM))


def check_rng(seed: int) -> np.random.Generator:
    """The generator that draws which requests the check keeps."""
    return np.random.default_rng([_entropy(seed), _CHECK])
