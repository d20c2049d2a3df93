"""ntt_ms_per_req: device time of the NTT kernels K1 and K2 (csrc/ntt.cu)
per request, attributed as ks_ms_per_req's is."""

from harness.kernels import NTT


def read(r):
    t = r.trace
    if t is None or t.busy_s is None or not r.completed:
        return None
    return t.device_s(NTT) * 1e3 / r.completed
