"""Spans at the host boundaries of the serving path, on the profiler's
clock.

`span(name)` is `torch.profiler.record_function(name)` while a profiler
records, and a shared null context otherwise (one check of the profiler's
state, under a microsecond: a bare record_function costs ~13 us even with
no profiler). So the spans cost nothing an operator has to switch off,
and there is no switch: to see them, run the server under the profiler,

    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        pub.execute(compiled, enc)
    prof.export_chrome_trace("trace.json")

and the spans appear as user annotations on the calling thread
(`is_user_annotation` in `prof.events()`), on one timeline with the CUDA
activity, so each idle gap of the card falls inside the host step that
held it. They nest: the self time of a span is its length less what its
`eva.` child spans cover.

SPANS, every name the program emits:

  eva.execute, eva.execute_batch  one call of EVAPublic.execute /
      execute_batch: parameter checks, the executor's look-up, the
      output valuation, and the spans below
  eva.host_phase  one valuation's planner work (Executor._host_phase):
      inputs' mod switches, raw ops, encode-cache look-ups, host encodes
  eva.stage       host arrays of a call into the captured graph's pinned
      staging buffers and the H2D copies' enqueue (_split, the capture
      key's look-up, _Captured.fill)
  eva.launch      CUDAGraph.replay on the host and the launch counters'
      update (_Captured.replay)
  eva.copy_out    pinned output buffers, the D2H copies' enqueue and the
      event after them (_copy_out)
  eva.wait        the host blocked on that event
  eva.result      one batch element's residues into host Ciphertexts
      (TorchProgram._result)
  eva.capture     a CUDA graph built for a new input key: tables,
      warm-up, capture (_capture_graph; set-up, not a request's step)

A request of execute_pipelined has no call span: its host_phase, stage,
launch and copy_out come at dispatch, its wait and result at collect,
in request order (the pipeline is first in, first out). On the CPU
(eager, no graph) a request shows eva.host_phase and eva.result alone.
The benchmark's tool `benchmark/tools/spans.py` reads each span's self
time per request and the card's idle time outside every span."""

from __future__ import annotations

import contextlib

import torch

SPANS = ("eva.execute", "eva.execute_batch", "eva.host_phase", "eva.stage",
         "eva.launch", "eva.copy_out", "eva.wait", "eva.result",
         "eva.capture")

_OFF = contextlib.nullcontext()


def span(name: str):
    """A context manager that records `name` as a profiler span while a
    profiler is recording, else does nothing."""
    if torch.autograd._profiler_enabled():
        return torch.profiler.record_function(name)
    return _OFF
