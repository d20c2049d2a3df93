"""A stream: EVAPublic.execute_pipelined over an endless iterator of the
requests, `depth` (a parameter of the mix) in flight. A request's
latency runs from when the iterator hands it over to when its output is
yielded."""

import time

from harness.traffic import positive


def drive(mix, server, program, requests, window, stop, first=0):
    clock = time.perf_counter
    pool = len(requests)
    depth = positive(mix, "depth")
    nxt = first
    handed = []

    def stream():
        nonlocal nxt
        while not stop(window):
            i = nxt % pool
            nxt += 1
            window.units += 1
            window.attempted += 1
            handed.append((i, clock()))
            yield requests[i]

    k = 0
    try:
        for out in server.execute_pipelined(program, stream(), depth=depth):
            i, t0 = handed[k]
            k += 1
            window.done(i, out, clock() - t0)
    except Exception as e:
        window.fail(window.attempted - k, e)
    if k + window.failed < window.attempted:
        window.fail(window.attempted - k - window.failed,
                    RuntimeError("the pipeline yielded fewer outputs than "
                                 "it was handed"))
    return nxt
