"""first_execute_s: seconds of the cell's first call into the server
(execute, execute_batch or the first pipelined request): its tables,
uploads and CUDA graph capture, by the benchmark's timer."""


def read(r):
    return r.first_execute_s
