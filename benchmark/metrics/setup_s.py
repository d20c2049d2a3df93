"""setup_s: seconds from the process's start to the first timed request,
less the build of the port's kernel libraries (nvcc, in the first run in
a checkout only; reported apart as setup_parts.build_s): imports,
compilation, key generation, encryption of the pool, the first call
(graph capture) and the warm-up."""


def read(r):
    return r.setup_s
