"""drain_wait_ms (ms/call, program span): the host's time in waits (syncs
and pageable copies, as host_wait_ms) inside the deepvcp.drain spans
(Registrar.stream copying a call's R to the host), per traced call: the
stream waiting on a device that is ahead of it."""

from benchmark import spans


def read(run):
    sp = spans.program_spans(run)
    return None if sp is None else spans.per_call_ms(run, sp.wait_ns(spans.DRAIN))
