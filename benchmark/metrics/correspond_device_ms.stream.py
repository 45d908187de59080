"""correspond_device_ms (ms/call, device trace): the device time of the work
launched inside the bench.correspond ranges (the candidates' neighbours,
DFE, CPG; every refinement), per traced call."""


def read(run):
    if run.trace is None:
        return None
    return run.per_traced_call(run.trace.range_device_ms("correspond"))
