"""band_max_roofline_pct (%, device trace): the least time of K1's work on
the traced calls' own clouds (benchmark/work.py band_max_bound_ms, from
their in-radius pairs) over the profiler's device time of K1's kernel by
name (band_max_kernel<...>)."""


def read(run):
    if run.trace is None or run.traced is None:
        return None
    ms = run.trace.kernel_ms("band_max_kernel<")
    bound = run.band_max_bound_ms(run.traced.calls)
    return None if not ms or bound is None else 100.0 * bound / ms
