"""candidates_roofline_pct (%, device trace): the least time of the flat
candidate stage's work (benchmark/work.py candidates_bound_ms: B*K*C x N
pairs at 10 operations, f32; the inputs read and the gathered rows written
once), for every refinement of every stage of the configuration, over the
device time launched inside the bench.candidate_neighbors ranges. The same
work whatever implements the stage; the flat path only (every stage flat)."""

from benchmark import manifest, work


def read(run):
    stages = manifest.stages(run.config)
    if run.trace is None or any(s["model"]["tgt_knn"] != "flat" for s in stages):
        return None
    ms = run.trace.range_device_ms("candidate_neighbors")
    if not ms:
        return None
    calls = len(run.traced.calls)
    bound = sum(calls * s["registrar"]["refine_iters"]
                * work.candidates_bound_ms(s["model"], run.batch) for s in stages)
    return 100.0 * bound / ms
