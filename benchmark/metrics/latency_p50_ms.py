"""latency_p50_ms (ms, host clock): the median over every call of the
measured window, a call timed from its issue until its pose (R, t) is on
the host. Closed-loop "call" traffic only."""

import statistics


def read(run):
    lat = run.window.latencies_s
    return 1e3 * statistics.median(lat) if lat else None
