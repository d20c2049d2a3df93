"""A backlog: EVAPublic.execute_batch on the next `batch` requests (a
parameter of the mix), the next batch sent when the previous one
returns. Every request of a batch has that batch's latency."""

import time

from harness.traffic import positive


def drive(mix, server, program, requests, window, stop, first=0):
    clock = time.perf_counter
    pool = len(requests)
    b = positive(mix, "batch")
    nxt = first
    while not stop(window):
        idx = [(nxt + j) % pool for j in range(b)]
        nxt += b
        window.units += 1
        window.attempted += b
        t0 = clock()
        try:
            outs = server.execute_batch(program, [requests[i] for i in idx])
            if len(outs) != b:
                raise RuntimeError(f"execute_batch returned {len(outs)} "
                                   f"outputs for {b} requests")
        except Exception as e:
            window.fail(b, e)
            break
        lat = clock() - t0
        for i, out in zip(idx, outs):
            window.done(i, out, lat)
    return nxt
