"""encode_device_ms (ms/call, device trace): the device time of the work
launched inside the bench.encode ranges (both FE passes, the weighting,
top-K, the source k-NN and DFE), per traced call."""


def read(run):
    return None if run.trace is None else run.per_traced_call(run.trace.range_device_ms("encode"))
