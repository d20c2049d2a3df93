"""ks_ms_per_req: device time of the key-switch kernels K4 and K5
(csrc/ks.cu) per request: their share of the union of device time, each
instant given to the earliest-started operation still running."""

from harness.kernels import KS


def read(r):
    t = r.trace
    if t is None or t.busy_s is None or not r.completed:
        return None
    return t.device_s(KS) * 1e3 / r.completed
