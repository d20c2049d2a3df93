"""The serving path's spans (eva_tpu_torch/tracing.py) on the CPU: free
when no profiler records, and under torch.profiler one span per host
step of each request, nested in its call's span, on the calling thread.
The card's spans (stage, launch, copy_out, wait, capture) are checked in
test_torch_cuda.py. Imports no JAX and no eva_tpu."""

import contextlib

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from eva_tpu_torch import tracing


@pytest.fixture(scope="module")
def served():
    """The SKILL.md polynomial (tests/test_torch_executor.py's round
    trip) with the port's own keys on the CPU, executed once so that
    the encode cache is warm, and 4 encrypted requests."""
    from eva_tpu_torch import EvaProgram, Input, Output
    from eva_tpu_torch.ckks import CKKSCompiler
    from eva_tpu_torch.runtime import generate_keys

    poly = EvaProgram("Polynomial", vec_size=1024)
    with poly:
        x = Input("x")
        Output("y", 3 * x ** 2 + 5 * x - 2)
    poly.set_output_ranges(20)
    poly.set_input_scales(30)
    compiled, params, sig = CKKSCompiler(
        {"warn_vec_size": "false"}).compile(poly)
    pub, _ = generate_keys(params, device="cpu")
    encs = [pub.encrypt({"x": [(i + k) * 0.001 for i in range(1024)]}, sig)
            for k in range(4)]
    pub.execute(compiled, encs[0])
    return pub, compiled, encs


def _spans(prof):
    """The eva. spans the profiler recorded, as (name, start, end,
    thread), by start."""
    return sorted(((e.name, e.time_range.start, e.time_range.end, e.thread)
                   for e in prof.events()
                   if e.is_user_annotation and e.name.startswith("eva.")),
                  key=lambda s: s[1])


def _traced(fn):
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        fn()
    return _spans(prof)


def _names(spans, name):
    return [s for s in spans if s[0] == name]


def _inside(inner, outer):
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def test_span_is_free_with_the_profiler_off(monkeypatch):
    def refuse(name):
        raise AssertionError(f"record_function({name!r}) with no profiler")

    monkeypatch.setattr(torch.profiler, "record_function", refuse)
    a, b = tracing.span("eva.execute"), tracing.span("eva.wait")
    assert a is b
    assert isinstance(a, contextlib.nullcontext)
    with a, b:
        pass


def test_execute_spans_nest_in_the_call(served):
    pub, compiled, encs = served
    spans = _traced(lambda: pub.execute(compiled, encs[1]))
    assert {s[0] for s in spans} <= set(tracing.SPANS)
    (call,) = _names(spans, "eva.execute")
    (plan,) = _names(spans, "eva.host_phase")
    (result,) = _names(spans, "eva.result")
    assert _inside(plan, call) and _inside(result, call)
    assert plan[2] <= result[1]
    assert {s[3] for s in spans} == {call[3]}


def test_execute_batch_spans_each_element(served):
    pub, compiled, encs = served
    spans = _traced(lambda: pub.execute_batch(compiled, encs[:3]))
    assert {s[0] for s in spans} <= set(tracing.SPANS)
    (call,) = _names(spans, "eva.execute_batch")
    for name in ("eva.host_phase", "eva.result"):
        found = _names(spans, name)
        assert len(found) == 3
        assert all(_inside(s, call) for s in found)
    assert not _names(spans, "eva.execute")


def test_pipelined_spans_follow_the_requests_in_order(served):
    pub, compiled, encs = served
    spans = _traced(lambda: list(pub.execute_pipelined(compiled, iter(encs),
                                                        depth=2)))
    assert {s[0] for s in spans} <= set(tracing.SPANS)
    plans = _names(spans, "eva.host_phase")
    results = _names(spans, "eva.result")
    assert len(plans) == len(results) == 4
    # Request k is planned before its result is built; at depth 2,
    # request k+3 is planned only after request k's result.
    assert all(p[2] <= r[1] for p, r in zip(plans, results))
    assert all(r[2] <= p[1] for r, p in zip(results, plans[3:]))
    assert not _names(spans, "eva.execute")
