"""idle_pct (%, device trace): 100 x (1 - the union of the device's
kernel, copy and fill intervals / the traced window), both from one trace."""


def read(run):
    idle = None if run.trace is None else run.trace.idle_share()
    return None if idle is None else 100.0 * idle
