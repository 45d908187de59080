"""The port's span census of one traced run of a cell, on the card:

    python3 benchmark/census.py --workload <cell> --seed <n> [--seconds <s>]

Runs the cell as `benchmark/run.py --trace 1` does (run.execute), keeps the
traced window's reduced trace and prints, per traced call, each `deepvcp.*`
span's row of spans.census, the syncs by span and op (spans.sync_sites) and
the runtime calls that took most time (spans.runtime_calls).
Then, in a fresh registrar on the same pool, a few calls of the cell's load
(after one warm call) under torch.cuda.set_sync_debug_mode("warn"), and each
synchronising operation it warned of, by the file:line of the Python frame
that called it, per call. The last line of standard output is the run's
result line. The benchmark's own runs do not run this.
"""

from __future__ import annotations

import argparse
import collections
import json
import os
import sys
import warnings
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

DEBUG_CALLS = 4
RUNTIME_ROWS = 30


def census_lines(trace) -> list:
    """The census, the sync sites and the runtime calls of a reduced trace,
    as text lines."""
    from benchmark import spans

    n = trace.calls
    lines = [f"census per call ({n} calls, window {1e3 * trace.window_s / n:.3f} ms a call, "
             f"busy {1e3 * trace.busy_s / n:.3f} ms, {trace.syncs / n:.2f} syncs):",
             "span " + " ".join(spans.CENSUS)]
    for name, row in spans.census(trace).items():
        lines.append(name + " " + " ".join(f"{row[c]:.4f}" for c in spans.CENSUS))
    lines.append("syncs per call by span / outermost op under it / innermost op around it:")
    lines += [f"{n:.2f} {' / '.join(site)}" for site, n in spans.sync_sites(trace).items()]
    lines.append("runtime calls per call by span / call: calls, ms, longest ms:")
    rows = list(spans.runtime_calls(trace).items())[:RUNTIME_ROWS]
    lines += [f"{span} / {name}: {k:.2f} {ms:.4f} {top:.4f}" for (span, name), (k, ms, top) in rows]
    return lines


def sync_debug_lines(config: dict, traffic: dict, seed: int, device) -> list:
    """The synchronising operations torch.cuda.set_sync_debug_mode("warn")
    reports in DEBUG_CALLS calls of the cell's load, by file:line, per call."""
    import torch

    from benchmark import drive, generate, manifest, system

    reg = system.build(config, system.params(config), device)
    pool = generate.make_pool(seed, traffic, manifest.num_points(config))
    B = int(traffic["batch"])
    batches = [(torch.from_numpy(pool.src[s:s + B]).to(device),
                torch.from_numpy(pool.tgt[s:s + B]).to(device))
               for s in range(0, int(traffic["pool"]), B)]
    drive.run(reg, batches, traffic, float("inf"), lambda *a: None, limit=1)
    torch.cuda.synchronize(device)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            drive.run(reg, batches, traffic, float("inf"), lambda *a: None, limit=DEBUG_CALLS)
        finally:
            torch.cuda.set_sync_debug_mode("default")
    sites = collections.Counter(
        (os.path.relpath(w.filename, ROOT), w.lineno, str(w.message).splitlines()[0][:80])
        for w in caught)
    lines = [f"set_sync_debug_mode warnings per call ({DEBUG_CALLS} calls):"]
    lines += [f"{n / DEBUG_CALLS:.2f} {f}:{line} {msg}"
              for (f, line, msg), n in sites.most_common()]
    return lines


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args(argv)

    import torch

    from benchmark import manifest, run, trace

    if not torch.cuda.is_available():
        print("census: needs a CUDA card", file=sys.stderr)
        return 2
    bench = manifest.load(ROOT)
    cell = manifest.workload(bench, args.workload)
    config = manifest.config(bench, cell["config"], ROOT)
    traffic = manifest.traffic(cell["traffic"])
    device = torch.device("cuda", torch.cuda.current_device())
    kept = []

    class Kept(trace.Trace):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            kept.append(self)

    trace.Trace = Kept
    try:
        result = run.execute(config, traffic, args.seed, args.seconds, True, device,
                             manifest.reported(bench, cell["name"]))
    finally:
        trace.Trace = Kept.__base__
    print("\n".join(census_lines(kept[0])))
    print("\n".join(sync_debug_lines(config, traffic, args.seed, device)))
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
