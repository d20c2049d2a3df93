"""Read a torch.profiler trace of the traced window: the device's busy
time as the union of its operations (kernels, copies, sets), that time
split by operation name, and the idle gaps by what the host was doing.

Only the window's own span (`WINDOW`, a record_function around the
traffic loop) bounds the reading, so set-up and the check are outside
it."""

from __future__ import annotations

import re
from typing import List, Optional, Tuple

from . import stats

WINDOW = "benchmark.window"
TOP = 10
LONG = 64


def short_name(name: str) -> str:
    """A device operation's name without its return type, arguments and
    anonymous namespace, and without its template arguments where those
    make it long: 'void (anonymous namespace)::divide_last_kernel<2>(unsigned
    int*, ...)' -> 'divide_last_kernel<2>' ('Memcpy HtoD (Pinned -> Device)'
    stays whole)."""
    name = re.sub(r"^void\s+", "", name.strip())
    name = name.replace("(anonymous namespace)::", "")
    depth = 0
    for i, ch in enumerate(name):
        if ch == "<":
            depth += 1
        elif ch == ">":
            depth -= 1
        elif ch == "(" and depth == 0 and i > 0 and name[i - 1] != " ":
            name = name[:i]
            break
    if len(name) > LONG and "<" in name:
        name = name[:name.index("<")] + "<...>"
    return name


def profiler_events(prof) -> Tuple[list, list]:
    """(host spans, device operations) of a finished torch.profiler run, as
    (name, start_s, end_s, thread) and (name, start_s, end_s). A
    record_function span shows on the device timeline too (as a
    "gpu_user_annotation" around the work it launched); those are
    spans, not operations, and are left out."""
    import torch

    cuda = torch.autograd.DeviceType.CUDA
    host, dev = [], []
    spans = {e.name for e in prof.events()
             if e.device_type != cuda and getattr(e, "is_user_annotation",
                                                  False)} | {WINDOW}
    for e in prof.events():
        s, t = e.time_range.start * 1e-6, e.time_range.end * 1e-6
        if e.device_type != cuda:
            host.append((e.name, s, t, e.thread))
        elif not (getattr(e, "is_user_annotation", False) or e.name in spans):
            dev.append((short_name(e.name), s, t))
    return host, dev


class TraceReading:
    """What the traced window shows: window_s, busy_s (None when the trace
    holds no device operation), device_s_by_name (the union's time by
    short operation name), and the breakdown of the result line."""

    def __init__(self, host: list, dev: list):
        wins = [(s, e, th) for n, s, e, th in host if n == WINDOW]
        if len(wins) != 1:
            raise RuntimeError(f"trace: expected one {WINDOW} span, "
                               f"found {len(wins)}")
        lo, hi, thread = wins[0]
        self.window_s = hi - lo
        ops = [(n, max(s, lo), min(e, hi)) for n, s, e in dev
               if e > lo and s < hi]
        self.device_ops = len(ops)
        self.busy_s: Optional[float] = None
        self.device_s_by_name: dict = {}
        self.idle_gaps: List[list] = []
        if not ops:
            return
        self.busy_s = stats.covered((s, e) for _, s, e in ops)
        self.device_s_by_name = stats.attribute(ops)
        idle = stats.gaps([(s, e) for _, s, e in ops], lo, hi)
        main = [(n, s, e) for n, s, e, th in host
                if th == thread and n != WINDOW]
        mids = [(s + e) / 2 for s, e in idle]
        by_host: dict = {}
        for (s, e), name in zip(idle, stats.innermost(main, mids)):
            name = name or "host (no span)"
            by_host[name] = by_host.get(name, 0.0) + (e - s)
        self.idle_gaps = sorted(([k, v] for k, v in by_host.items()),
                                key=lambda kv: -kv[1])[:TOP]

    def device_s(self, names, invert: bool = False) -> float:
        """Seconds of the union attributed to operations whose name
        contains one of `names` (inverted: none of them)."""
        return sum(v for k, v in self.device_s_by_name.items()
                   if any(n in k for n in names) != invert)

    def breakdown(self) -> dict:
        ops = sorted(([k, v] for k, v in self.device_s_by_name.items()),
                     key=lambda kv: -kv[1])[:TOP]
        return {"device_ops": ops, "idle_gaps": self.idle_gaps}
