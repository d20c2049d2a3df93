"""torch_ops_ms_per_req: device time of every other device operation per
request: PyTorch's own kernels inside the captured program (gathers,
cat, index_select, copies) and the input and output copies."""

from harness.kernels import EW, KS, NTT


def read(r):
    t = r.trace
    if t is None or t.busy_s is None or not r.completed:
        return None
    return t.device_s(NTT + KS + EW, invert=True) * 1e3 / r.completed
