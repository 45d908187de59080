"""solve_syncs (syncs/call, program span): the host syncs (trace.SYNCS)
inside the program's deepvcp.solve spans (loss.registration.svd_refine:
both Kabsch passes and the trim), per traced call."""

from benchmark import spans


def read(run):
    sp = spans.program_spans(run)
    return None if sp is None else sp.sync_count(spans.SOLVE) / run.trace.calls
