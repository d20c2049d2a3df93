"""keygen_s: seconds of runtime.generate_keys on the device (host
sampling and the device's key arithmetic), by the benchmark's timer."""


def read(r):
    return r.keygen_s
