"""candidates_roofline_pct (%, device trace): the least time of the flat
candidate stage's work (benchmark/work.py candidates_bound_ms: B*K*C x N
pairs at 10 operations, f32; the inputs read and the gathered rows written
once) over the device time launched inside the bench.candidate_neighbors
ranges. The same work whatever implements the stage; the flat path only."""

from benchmark import work


def read(run):
    if run.trace is None or run.config["model"]["tgt_knn"] != "flat":
        return None
    ms = run.trace.range_device_ms("candidate_neighbors")
    if not ms:
        return None
    stages = len(run.traced.calls) * run.config["registrar"]["refine_iters"]
    return 100.0 * stages * work.candidates_bound_ms(run.config["model"], run.batch) / ms
