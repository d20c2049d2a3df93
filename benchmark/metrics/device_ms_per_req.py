"""device_ms_per_req: the device's busy time in the traced window (the
union of its operations' intervals) over the requests completed there."""


def read(r):
    t = r.trace
    if t is None or t.busy_s is None or not r.completed:
        return None
    return t.busy_s * 1e3 / r.completed
