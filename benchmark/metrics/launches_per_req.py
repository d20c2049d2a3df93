"""launches_per_req: the port's own count of its CUDA kernel launches
(the LAUNCHES counters of ntt_cuda, ks_cuda, modmath_cuda and
ntt_shard_cuda; a K5 epilogue call counts once) in the traced window,
over the requests completed there."""


def read(r):
    if r.launches is None or not r.completed:
        return None
    return r.launches / r.completed
