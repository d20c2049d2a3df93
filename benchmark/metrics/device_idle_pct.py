"""device_idle_pct: the share of the traced window in which no device
operation (kernel, copy, set) ran: 1 - union of their intervals over the
window. The union, not the sum: with programmatic dependent launch
kernels overlap."""


def read(r):
    t = r.trace
    if t is None or t.busy_s is None or not t.window_s > 0:
        return None
    return 100.0 * (1.0 - t.busy_s / t.window_s)
