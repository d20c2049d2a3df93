import types

import pytest

from harness import trace
from harness.trace import WINDOW, TraceReading


def test_short_name():
    assert trace.short_name(
        "void divide_last_kernel<2>(unsigned int*, int)") == \
        "divide_last_kernel<2>"
    assert trace.short_name("Memcpy HtoD (Pinned -> Device)") == \
        "Memcpy HtoD (Pinned -> Device)"
    assert trace.short_name("ntt_fwd_kernel") == "ntt_fwd_kernel"
    assert trace.short_name(
        "void (anonymous namespace)::mod_ew_multi_kernel<4, 4>(Args)") == \
        "mod_ew_multi_kernel<4, 4>"
    long = ("void at::native::_scatter_gather_elementwise_kernel<128, 8, "
            "at::native::_cuda_scatter_gather_internal_kernel<false, "
            "at::native::OpaqueType<4>, long>::operator()<at::native::"
            "TensorAssign>(at::TensorIterator&, long)::{lambda(int)#1}>"
            "(int, {lambda(int)#1})")
    assert trace.short_name(long) == \
        "at::native::_scatter_gather_elementwise_kernel<...>"


def test_reading_of_a_window():
    host = [(WINDOW, 0.0, 10.0, 1), ("execute", 0.6, 9.5, 1),
            ("cudaEventSynchronize", 4.0, 6.0, 1), ("other", 0, 10, 2)]
    dev = [("k1", 1.0, 3.0), ("k2", 2.5, 4.0), ("k3", 7.0, 8.0),
           ("before", -2.0, -1.0)]
    r = TraceReading(host, dev)
    assert r.window_s == 10.0
    assert r.busy_s == pytest.approx(4.0)
    assert r.device_s_by_name == pytest.approx({"k1": 2.0, "k2": 1.0,
                                                "k3": 1.0})
    gaps = dict(r.idle_gaps)
    # [0,1] host in no span, [4,7] mid 5.5 in the sync, [8,10] in execute
    assert gaps == pytest.approx({"host (no span)": 1.0,
                                  "cudaEventSynchronize": 3.0,
                                  "execute": 2.0})
    bd = r.breakdown()
    assert bd["device_ops"][0] == ["k1", 2.0]


def test_reading_without_device_operations():
    r = TraceReading([(WINDOW, 0.0, 1.0, 1)], [])
    assert r.busy_s is None and r.device_s_by_name == {}


def test_reading_needs_one_window():
    with pytest.raises(RuntimeError):
        TraceReading([], [])


def test_profiler_events_leave_out_device_annotations():
    import torch
    cuda, cpu = torch.autograd.DeviceType.CUDA, torch.autograd.DeviceType.CPU

    def ev(name, s, e, dt, ann=False):
        return types.SimpleNamespace(
            name=name, device_type=dt, thread=1, is_user_annotation=ann,
            time_range=types.SimpleNamespace(start=s, end=e))

    prof = types.SimpleNamespace(events=lambda: [
        ev(WINDOW, 0, 100, cpu, True), ev(WINDOW, 5, 90, cuda, True),
        ev("void ntt_fwd_kernel(int*)", 10, 20, cuda),
        ev("aten::copy_", 1, 2, cpu)])
    host, dev = trace.profiler_events(prof)
    assert dev == [("ntt_fwd_kernel", pytest.approx(10e-6), pytest.approx(20e-6))]
    assert [h[0] for h in host] == [WINDOW, "aten::copy_"]


def test_the_per_layer_readers_split_the_device_time(bench):
    """Each metrics/<name>.py reads a traced window on its own; the four
    families share out the union, and without a trace they read
    nothing."""
    host = [(WINDOW, 0.0, 10.0, 1)]
    dev = [("ntt_fwd_kernel", 0.0, 1.0), ("ks_mac_cluster_kernel", 0.5, 2.0),
           ("mod_ew_kernel", 2.0, 3.0), ("Memcpy DtoH", 3.0, 5.0)]
    reading = types.SimpleNamespace(trace=TraceReading(host, dev),
                                    completed=4, launches=12)
    read = {m: bench.reader(m)(reading) for m in (
        "device_idle_pct", "device_ms_per_req", "launches_per_req",
        "ntt_ms_per_req", "ks_ms_per_req", "ew_ms_per_req",
        "torch_ops_ms_per_req")}
    assert read["device_idle_pct"] == pytest.approx(50.0)
    assert read["device_ms_per_req"] == pytest.approx(1250.0)
    assert read["launches_per_req"] == 3
    assert [read[k] for k in ("ntt_ms_per_req", "ks_ms_per_req",
                              "ew_ms_per_req", "torch_ops_ms_per_req")] \
        == pytest.approx([250.0, 250.0, 250.0, 500.0])
    bare = types.SimpleNamespace(trace=None, completed=4, launches=None)
    for m in read:
        assert bench.reader(m)(bare) is None
