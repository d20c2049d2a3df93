"""What every traffic loop shares. A mix (traffic/<mix>.json) is data:
the loop it runs (`loop`, a module traffic/<loop>.py with a
`drive(mix, server, program, requests, window, stop, first)`) and that
loop's parameters, among them

  "pool":         the number of distinct encrypted requests, used in turn
  "warmup_units": units (calls) run in set-up after the first
  "trace_units":  units run under the profiler in a traced run

A loop is closed: the next unit starts when the previous one has
returned, so no rate is searched for. A request's latency runs from the
moment the client hands it over to the moment its output ciphertexts
are on the host. A new kind of traffic is a new loop file; a new mix of
an existing loop is a data file alone."""

from __future__ import annotations

import random
import time
from typing import Callable, List, Optional

UNIT_KEYS = ("pool", "warmup_units", "trace_units")


def check_mix(mix: dict) -> None:
    for key in UNIT_KEYS:
        positive(mix, key)


def positive(mix: dict, key: str) -> int:
    """mix[key], which must be a whole number >= 1."""
    v = mix.get(key)
    if not (isinstance(v, int) and v >= 1):
        raise ValueError(f"traffic {mix.get('name')}: {key} must be a "
                         f"whole number >= 1")
    return v


class Window:
    """What one stretch of traffic did: units (calls) and requests
    attempted, completed and failed, every completed request's latency
    in seconds, the host clock at its start and end, and a sample of
    outputs: for each pool entry, one of the outputs it produced, drawn
    uniformly (reservoir sampling from `rng`)."""

    def __init__(self, pool: int, rng: Optional[random.Random] = None):
        self.units = 0
        self.attempted = 0
        self.completed = 0
        self.failed = 0
        self.latencies: List[float] = []
        self.finished: List[float] = []
        self.errors: List[str] = []
        self.start = self.end = None
        self.sample: List = [None] * pool
        self._seen = [0] * pool
        self._rng = rng

    @property
    def seconds(self) -> float:
        return self.end - self.start

    def done(self, index: int, outputs, latency: float) -> None:
        self.completed += 1
        self.latencies.append(latency)
        self.finished.append(time.perf_counter())
        if self._rng is not None:
            self._seen[index] += 1
            if self._rng.random() * self._seen[index] < 1.0:
                self.sample[index] = outputs

    def by_second(self) -> List[int]:
        """Requests completed in each whole second of the window."""
        counts = [0] * int(self.seconds)
        for t in self.finished:
            k = int(t - self.start)
            if k < len(counts):
                counts[k] += 1
        return counts

    def fail(self, count: int, err: BaseException) -> None:
        self.failed += count
        if len(self.errors) < 5:
            self.errors.append(f"{type(err).__name__}: {err}")


def drive(loop, mix: dict, server, program, requests: list, window: Window,
          stop: Callable[[Window], bool], first: int = 0) -> int:
    """Run `loop` (a traffic/<loop>.py module) on `server` (an EVAPublic)
    until `stop(window)` is true before a unit would start; request k of
    the stream is requests[(first + k) % len(requests)]. Returns the
    index after the last request handed over. The first failing call
    ends the loop."""
    window.start = time.perf_counter()
    nxt = loop.drive(mix, server, program, requests, window, stop, first)
    window.end = time.perf_counter()
    return nxt


def until_units(n: int, seconds: Optional[float] = None
                ) -> Callable[[Window], bool]:
    """Stop after n units, or once `seconds` have passed since the
    window's start."""
    if seconds is None:
        return lambda w: w.units >= n
    return lambda w: (w.units >= n
                      or time.perf_counter() >= w.start + seconds)


def until_time(deadline: float) -> Callable[[Window], bool]:
    return lambda w: time.perf_counter() >= deadline
