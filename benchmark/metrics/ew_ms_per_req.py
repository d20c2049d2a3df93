"""ew_ms_per_req: device time of the elementwise modular kernels E1-E3
(csrc/modmath.cu) per request, attributed as ks_ms_per_req's is."""

from harness.kernels import EW


def read(r):
    t = r.trace
    if t is None or t.busy_s is None or not r.completed:
        return None
    return t.device_s(EW) * 1e3 / r.completed
