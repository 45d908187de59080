"""solve_idle_ms (ms/call, program span): the device idle of the gaps in
which a sync inside a deepvcp.solve span returned, per traced call: the
idle that the solve's waits expose, from the device running dry until the
host has issued the next work."""

from benchmark import spans


def read(run):
    sp = spans.program_spans(run)
    return None if sp is None else spans.per_call_ms(run, sp.exposed_idle_ns(spans.SOLVE))
