"""latency_p50_ms: the median latency over every request of the window,
from the client's hand-over to its output ciphertexts on the host."""

from harness.stats import percentile


def read(r):
    return percentile(r.latencies_s, 50) * 1e3 if r.latencies_s else None
