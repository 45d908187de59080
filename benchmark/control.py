"""The readings that a cell's limits are set from, on the card, in one
process:

    python3 benchmark/control.py --workload <cell> --seeds 1 2 3 ... [--control-seeds 1 2 3]

For each seed: the pool of that seed, a short window of the cell's own load
through the port (the timed path's entry, batch and depth, 4 x check_calls
calls, a sample of check_calls of them drawn from the seed, as a run draws
it), and the numbers of benchmark/check.py for the sample against the plain
reference. For each control seed also the control's numbers: the reference
computed in TF32 (the nearest precision below the configuration's float32
with TF32 off), put in the program's place and held to the same reference.
Prints one JSON line a seed and side, then the largest program reading and
the smallest control reading of each number. The benchmark's own runs do not
run this.
"""

from __future__ import annotations

import argparse
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(config: dict, traffic: dict, seeds, control_seeds, device) -> list:
    """[{"seed", "side": "program" | "control", numbers...}] for the cell."""
    import torch

    from benchmark import check, drive, generate, system
    from benchmark.reference.deepvcp import Reference, load_npz

    params = load_npz(str(ROOT / config["weights"]))
    reg = system.registrar(config, params, device)
    reference = Reference(config, params, device)
    control = Reference(config, params, device, allow_tf32=True)
    B, P = int(traffic["batch"]), int(traffic["pool"])
    k = int(traffic["check_calls"])
    rows = []
    for seed in seeds:
        pool = generate.make_pool(seed, traffic, int(config["model"]["num_points"]))
        src = torch.from_numpy(pool.src).to(device)
        tgt = torch.from_numpy(pool.tgt).to(device)
        batches = [(src[s:s + B], tgt[s:s + B]) for s in range(0, P, B)]
        sample = drive.Reservoir(k, seed)
        drive.run(reg, batches, traffic, float("inf"), sample.offer, limit=4 * k)
        items = [(b, {n: v.detach() for n, v in out.items()}) for b, out in sample.items]
        rows.append({"seed": seed, "side": "program",
                     **check.compare(reference, items, batches)})
        if seed in control_seeds:
            per_call = [check.readings(control.register(*batches[b]),
                                       reference.register(*batches[b])) for b, _ in items]
            rows.append({"seed": seed, "side": "control", **check.worst(per_call)})
    return rows


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--control-seeds", type=int, nargs="*", default=None)
    args = p.parse_args(argv)

    import torch

    from benchmark import check, manifest

    bench = manifest.load(ROOT)
    cell = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available():
        print("benchmark/control.py: no CUDA card", file=sys.stderr)
        return 2
    config = manifest.config(bench, cell["config"], ROOT)
    control_seeds = args.seeds[:3] if args.control_seeds is None else args.control_seeds
    rows = readings(config, manifest.traffic(cell["traffic"]),
                    args.seeds + [s for s in control_seeds if s not in args.seeds],
                    set(control_seeds), torch.device("cuda", torch.cuda.current_device()))
    for row in rows:
        print(json.dumps({"workload": args.workload, **row}))
    summary = {}
    for name in check.NUMBERS:
        prog = [r[name] for r in rows if r["side"] == "program"]
        ctrl = [r[name] for r in rows if r["side"] == "control"]
        summary[name] = {"program_max": max(prog), "control_min": min(ctrl) if ctrl else None}
    print(json.dumps({"workload": args.workload, "summary": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
