"""latency_p95_ms: the 95th percentile of latency over every request of
the window (not of chunks of it)."""

from harness.stats import percentile


def read(r):
    return percentile(r.latencies_s, 95) * 1e3 if r.latencies_s else None
