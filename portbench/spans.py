"""Harness spans: host-clock intervals around the calls into each layer.

Each span synchronizes the device at its start and at its end, so it covers
the device work of what it wraps; spans nest, and a record names its whole
path ("request/solve/apply").  Kept in memory for the run.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time


@dataclasses.dataclass(frozen=True)
class Span:
    path: str
    t0_ns: int
    t1_ns: int
    request: int

    @property
    def name(self) -> str:
        return self.path.rsplit("/", 1)[-1]

    @property
    def ms(self) -> float:
        return (self.t1_ns - self.t0_ns) / 1e6


class Spans:
    def __init__(self, sync):
        self._sync = sync
        self._stack: list[str] = []
        self.records: list[Span] = []
        self.request = -1

    @contextlib.contextmanager
    def span(self, name: str):
        self._sync()
        self._stack.append(name)
        t0 = time.perf_counter_ns()
        try:
            yield
        finally:
            self._sync()
            t1 = time.perf_counter_ns()
            self.records.append(Span("/".join(self._stack), t0, t1,
                                     self.request))
            self._stack.pop()
