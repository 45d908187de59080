"""host_issue_ms (ms/call, program span): the host's time in the
deepvcp.register spans (Registrar.__call__) less its waits inside them
(benchmark/spans.py: syncs, and copies to or from pageable host memory), per
traced call: Python, dispatch and kernel launches."""

from benchmark import spans


def read(run):
    sp = spans.program_spans(run)
    if sp is None:
        return None
    return spans.per_call_ms(run, sp.span_ns(spans.REGISTER) - sp.wait_ns(spans.REGISTER))
