"""latency_p95_ms (ms, host clock): the 95th percentile (inclusive
quantiles) of the same calls as latency_p50_ms."""

import statistics


def read(run):
    lat = run.window.latencies_s
    if len(lat) < 20:
        return None
    return 1e3 * statistics.quantiles(lat, n=20, method="inclusive")[18]
