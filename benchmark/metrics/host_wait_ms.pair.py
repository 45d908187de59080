"""host_wait_ms (ms/call, program span): the host's time in waits inside
the deepvcp.register spans (Registrar.__call__), per traced call: the syncs
(trace.SYNCS) and the copies to or from pageable host memory, in which the
host waits for all the work issued before them (the SVD's copy to the host
holds most of it). In the stream it is also why calls do not overlap."""

from benchmark import spans


def read(run):
    sp = spans.program_spans(run)
    return None if sp is None else spans.per_call_ms(run, sp.wait_ns(spans.REGISTER))
