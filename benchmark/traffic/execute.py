"""One client, one request in flight: EVAPublic.execute on the next
request, the client waiting for its output ciphertexts on the host
before it sends the next."""

import time


def drive(mix, server, program, requests, window, stop, first=0):
    clock = time.perf_counter
    pool = len(requests)
    nxt = first
    while not stop(window):
        i = nxt % pool
        nxt += 1
        window.units += 1
        window.attempted += 1
        t0 = clock()
        try:
            out = server.execute(program, requests[i])
        except Exception as e:  # the server's failure is the result
            window.fail(1, e)
            break
        window.done(i, out, clock() - t0)
    return nxt
