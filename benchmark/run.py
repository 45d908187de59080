"""The benchmark's one command, from the root of a checkout:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

A run builds the cell's system (the port's Registrar on the configuration's
weights), makes the pool of pairs from the seed, moves it to the card, warms
up the cell's shapes (set-up, timed as setup_s from the process start to
the first timed call), then measures for --seconds. With --trace 1 it also
counts the pool's work in its set-up, and after the measured window runs a
traced one (benchmark/trace.py). Then it frees the system, runs the plain
reference on a sample of the calls drawn from the seed (benchmark/check.py)
and prints, as its last lines on standard error, each compared number
beside its limit, and as the last line of standard output one JSON object:
correct, attempted, failed, metrics (the cell's end-to-end metrics with
--trace 0, its per-layer metrics with --trace 1), device (and busy_s,
window_s and a breakdown with --trace 1) and, last, the checks.

It exits non-zero, with no result, where no CUDA card is visible or fewer
than the cell asks for, and where a module whose top-level name is jax,
jaxlib, flax or deepvcp_tpu has been loaded.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# every cache a run may fill lives at a fixed path inside the checkout (the
# port builds its kernels into deepvcp_tpu_torch/_build/ beside its sources)
for _var, _sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                   ("CUDA_CACHE_PATH", "cuda")):
    os.environ[_var] = str(ROOT / ".bench_cache" / _sub)
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

FORBIDDEN = ("jax", "jaxlib", "flax", "deepvcp_tpu")


def forbidden_modules(modules=None) -> list:
    """The loaded modules whose top-level name (before the first dot) is one
    of FORBIDDEN, compared as whole names."""
    modules = sys.modules if modules is None else modules
    return sorted({name.split(".")[0] for name in list(modules)} & set(FORBIDDEN))


def _sync(device) -> None:
    import torch

    if device.type == "cuda":
        torch.cuda.synchronize(device)


def execute(config: dict, traffic: dict, seed: int, seconds: float, trace: bool, device,
            reported: dict, t_start: float = T_START) -> dict:
    """One run of the cell of `config` and `traffic` on `device`: set-up,
    the measured window, with `trace` the traced window, then the
    reference's comparison. `reported`: manifest.reported's metrics of the
    cell. Returns the result line's object (the caller checks the card)."""
    import torch

    from benchmark import check, drive, generate, manifest, system, work
    from benchmark import trace as tracing
    from benchmark.record import Run
    from benchmark.reference.deepvcp import Reference, load_npz

    torch.backends.cuda.matmul.allow_tf32 = bool(config["precision"]["allow_tf32"])
    torch.backends.cudnn.allow_tf32 = bool(config["precision"]["allow_tf32"])
    params = load_npz(str(ROOT / config["weights"]))
    N = int(config["model"]["num_points"])
    pool = generate.make_pool(seed, traffic, N)
    B, P = int(traffic["batch"]), int(traffic["pool"])
    if P % B:
        raise ValueError(f"the pool ({P}) must hold whole batches of {B}")
    reg = system.registrar(config, params, device)
    src = torch.from_numpy(pool.src).to(device)
    tgt = torch.from_numpy(pool.tgt).to(device)
    batches = [(src[s:s + B], tgt[s:s + B]) for s in range(0, P, B)]
    pairs = [list(range(s, s + B)) for s in range(0, P, B)]
    drive.run(reg, batches, traffic, float("inf"), lambda *a: None,
              limit=int(traffic["warmup_calls"]))
    pool_work = work.pool_work(config, src, tgt) if trace else None
    _sync(device)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    setup_s = time.perf_counter() - t_start

    sample = drive.Reservoir(int(traffic["check_calls"]), seed)
    window = drive.run(reg, batches, traffic, seconds, sample.offer)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    traced = reduced = None
    if trace:
        with tracing.spans(reg.model), tracing.profiler() as prof:
            with tracing.span("window"):
                traced = drive.run(reg, batches, traffic, float("inf"), sample.offer,
                                   limit=int(traffic["trace_calls"]), first=window.issued)
                _sync(device)
        reduced = tracing.Trace(prof, len(traced.calls))
        del prof
    run = Run(config=config, traffic=traffic, setup_s=setup_s, window=window, peak_bytes=peak,
              pairs=pairs, traced=traced, trace=reduced, pool_work=pool_work)
    kind = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in reported[kind]:
        value = manifest.reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    attempted = B * (window.issued + (traced.issued if traced else 0))
    failed = window.failed + (traced.failed if traced else 0)

    # the program's state goes before the reference runs
    items = [(b, {k: v.detach().cpu() for k, v in out.items()}) for b, out in sample.items]
    sample.items.clear()
    del reg, run, window, traced
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    reference = Reference(config, params, device)
    numbers = check.compare(reference, items, batches)
    correct, checks = check.judge(numbers, config["limits"])
    if reduced is not None:
        print(f"trace: {len(reduced.device)} device activities ({reduced.unlinked} not linked "
              f"to a launch), {reduced.syncs} syncs, {reduced.calls} calls, ranges "
              f"{ {k: len(v) for k, v in reduced.ranges.items()} }", file=sys.stderr)
    print("readings (sample of " + ", ".join(str(b) for b, _ in items) + "): " + ", ".join(
        f"{k} {v!r}" for k, v in numbers.items()), file=sys.stderr)
    device_info = {"platform": "gpu" if device.type == "cuda" else device.type,
                   "kind": torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu",
                   "count": 1, "memory_peak_bytes": int(peak)}
    result = {"correct": correct and failed == 0, "attempted": attempted, "failed": failed,
              "metrics": metrics, "device": device_info}
    if reduced is not None:
        device_info["busy_s"] = reduced.busy_s
        device_info["window_s"] = reduced.window_s
        result["breakdown"] = reduced.breakdown()
    result["checks"] = checks
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    import torch

    from benchmark import manifest

    bench = manifest.load(ROOT)
    cell = manifest.workload(bench, args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"benchmark: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"torch.cuda.is_available() is {torch.cuda.is_available()}, "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} visible",
              file=sys.stderr)
        return 2
    result = execute(manifest.config(bench, cell["config"], ROOT),
                     manifest.traffic(cell["traffic"]), args.seed, args.seconds,
                     bool(args.trace), torch.device("cuda", torch.cuda.current_device()),
                     manifest.reported(bench, cell["name"]))
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: the run loaded {bad}: the port and the benchmark import "
              f"no JAX", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
