"""host_syncs (syncs/call, device trace): the cudaStreamSynchronize,
cudaDeviceSynchronize and cudaEventSynchronize runtime calls in the traced
window over its calls. The harness's own pose copy (one a call) is
included, a fixed number."""


def read(run):
    if run.trace is None or not run.trace.calls:
        return None
    return run.trace.syncs / run.trace.calls
