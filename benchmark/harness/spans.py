"""The program's own spans in a traced window: the `eva.` ranges that
eva_tpu_torch/tracing.py records on the calling thread, read from the
host events of trace.profiler_events, beside the device operations.

  span_self_s       each span name's self time inside the window: its
                    spans' lengths less the part that their `eva.` child
                    spans cover (a capture inside a stage is capture)
  span_count        each span name's count inside the window
  idle_s            the device's idle time (the gaps of
                    device_idle_pct; None without device operations)
  idle_unspanned_s  the part of it at whose instants no `eva.` span is
                    open: idle time the spans cannot put down to a step

`per_request` turns them into the layers' numbers a request (LAYERS). A
reading of a program without spans finds none and gives nothing."""

from __future__ import annotations

from collections import Counter
from typing import Optional

from . import stats
from .trace import WINDOW

PREFIX = "eva."

# Per-layer numbers a request: name -> the spans whose self time it sums.
LAYERS = {
    "entry_ms_per_req": ("eva.execute", "eva.execute_batch"),
    "host_phase_ms_per_req": ("eva.host_phase",),
    "stage_ms_per_req": ("eva.stage",),
    "launch_ms_per_req": ("eva.launch",),
    "output_ms_per_req": ("eva.copy_out", "eva.result"),
    "host_wait_ms_per_req": ("eva.wait",),
}


def self_times(spans) -> dict:
    """Self time by name of nested (name, start, end) spans of one
    thread: each span's length less what its direct children cover."""
    out: dict = {}
    stack: list = []

    def close(top):
        name, s, e, child = top
        out[name] = out.get(name, 0.0) + (e - s) - child

    for name, s, e in sorted(spans, key=lambda x: (x[1], -x[2])):
        while stack and stack[-1][2] <= s:
            close(stack.pop())
        if stack:
            stack[-1][3] += min(e, stack[-1][2]) - s
        stack.append([name, s, e, 0.0])
    while stack:
        close(stack.pop())
    return out


class SpanReading:
    """The spans of the window (trace.WINDOW) in (host, dev), as
    trace.profiler_events returns them."""

    def __init__(self, host: list, dev: list):
        wins = [(s, e, th) for n, s, e, th in host if n == WINDOW]
        if len(wins) != 1:
            raise RuntimeError(f"spans: expected one {WINDOW} span, "
                               f"found {len(wins)}")
        lo, hi, thread = wins[0]
        self.window_s = hi - lo
        spans = [(n, max(s, lo), min(e, hi)) for n, s, e, th in host
                 if th == thread and n.startswith(PREFIX) and e > lo
                 and s < hi]
        self.span_count = dict(Counter(n for n, _, _ in spans))
        self.span_self_s = self_times(spans)
        ops = stats.clip([(s, e) for _, s, e in dev], lo, hi)
        self.idle_s: Optional[float] = None
        self.idle_unspanned_s: Optional[float] = None
        if ops:
            self.idle_s = self.window_s - stats.covered(ops)
            self.idle_unspanned_s = self.window_s - stats.covered(
                ops + [(s, e) for _, s, e in spans])


def per_request(r: SpanReading, completed: int) -> dict:
    """The layers' ms a request (LAYERS), idle_unspanned_pct (100 x
    idle_unspanned_s / idle_s) and captures_in_window; empty where the
    window holds no span or no completed request."""
    if not r.span_count or not completed:
        return {}
    out = {name: 1e3 * sum(r.span_self_s.get(s, 0.0) for s in spans)
           / completed for name, spans in LAYERS.items()}
    if r.idle_s:
        out["idle_unspanned_pct"] = 100.0 * r.idle_unspanned_s / r.idle_s
    out["captures_in_window"] = r.span_count.get("eva.capture", 0)
    return out
