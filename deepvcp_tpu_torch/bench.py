"""Headline benchmark of the port: end-to-end registration pairs/s on one
card (counterpart of the root bench.py).

    python -m deepvcp_tpu_torch.bench [--num-points 10000] [--batch 1]
                                      [--iters 10] [--warmup 2] [--cpu]

Times the full inference path (DeepVCP forward + ground-truth-free two-pass
SVD pose solve, `Registrar` with refine_iters 1 and the guard) under the
default `DeepVCPConfig` at the reference's full operating point: N = 10 000
points a cloud, K = 64 keypoints, 216 candidates, 32 neighbours. That is the
banded SA on the exact slab (kernel K1), top-K keypoints, the flat candidate
KNN and the bf16 selection tile. The weights are a random init drawn from a
torch.Generator seeded 0; the pairs are `SyntheticDataset` clouds of extent
10. Runs on the card unless given --cpu; a failure raises.

Per-call latency ends each call by copying R to the host; the stream runs
max(2 iters, 10) calls back to back with one copy at the end, best of 3.

Baseline: the DeepVCP paper reports ~2 s per registered pair on a GTX 1080
Ti (BASELINE.md), i.e. 0.5 pairs/s.

Prints its progress on standard error and, last on standard output, ONE JSON
line: {"metric", "value", "unit", "vs_baseline"}.
"""

from __future__ import annotations

import argparse
import json
import math
import sys
import time

import torch

BASELINE_PAIRS_PER_SEC = 0.5  # paper: ~2 s/pair on GTX 1080 Ti
METRIC = "torch_registration_pairs_per_sec"


def random_state(cfg, seed: int = 0) -> dict:
    """The state dict of `create_deepvcp(cfg)` with every Linear and Conv3d
    weight and bias drawn, in module order, from a torch.Generator seeded
    `seed`: uniform on +-1/sqrt(fan_in), torch's default init. BatchNorm
    and the SA stages' bias0 keep their constant inits."""
    from deepvcp_tpu_torch.models import create_deepvcp

    model = create_deepvcp(cfg)
    gen = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for mod in model.modules():
            if isinstance(mod, (torch.nn.Linear, torch.nn.Conv3d)):
                bound = 1.0 / math.sqrt(mod.weight[0].numel())
                for p in (mod.weight, mod.bias):
                    if p is not None:
                        p.uniform_(-bound, bound, generator=gen)
    return model.state_dict()


def inputs(num_points: int, batch: int):
    """The bench's pairs as numpy arrays (src, tgt [B, N, 3], R [B, 3, 3],
    t [B, 3]): the root bench.py's SyntheticDataset batch."""
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=batch, num_points=num_points, use_normal=False,
                          extent=10.0)
    return next(batch_iterator(ds, batch, epoch=0, seed=0))


def run(num_points: int = 10000, batch: int = 1, iters: int = 10, warmup: int = 2,
        device="cuda") -> dict:
    """Builds the registrar and the pairs on `device` and times them as
    main() does. Returns the JSON line's four keys and "first_call_s",
    "latency_ms" (the per-call times), "stream_ms" (the best stream's time
    a call), "calls" (the registrar calls made), "registrar", "src", "tgt"
    and "out" (the last call's RegistrationOutput)."""
    from deepvcp_tpu_torch.config import DeepVCPConfig
    from deepvcp_tpu_torch.registration import Registrar

    device = torch.device(device)
    print(f"device: {device}"
          + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""),
          file=sys.stderr)
    cfg = DeepVCPConfig(num_points=num_points, use_normal=False)
    src, tgt, _, _ = (torch.from_numpy(a) for a in inputs(num_points, batch))

    t0 = time.perf_counter()
    reg = Registrar(cfg, random_state(cfg, seed=0), device)
    src, tgt = src.to(reg.device), tgt.to(reg.device)
    print(f"init: {time.perf_counter() - t0:.1f}s", file=sys.stderr)

    def run_sync():
        # the pose on the host: the call's work on the card has ended
        out = reg(src, tgt)
        out.R.cpu()
        return out

    t0 = time.perf_counter()
    run_sync()
    first = time.perf_counter() - t0
    print(f"build + first run: {first:.1f}s", file=sys.stderr)

    for _ in range(max(warmup - 1, 0)):
        run_sync()

    times = []
    for _ in range(iters):
        t0 = time.perf_counter()
        run_sync()
        times.append(time.perf_counter() - t0)
    print(f"per-call latency best: {min(times) * 1e3:.1f} ms "
          f"({batch / min(times):.2f} pairs/s); per-call times: "
          f"{[f'{x:.3f}' for x in times]}", file=sys.stderr)

    # the serving rate: calls issued back to back, one copy to the host at
    # the end (each call still syncs on its own SVD: ops/kabsch.py)
    stream = max(iters * 2, 10)
    out = run_sync()
    best = None
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(stream):
            out = reg(src, tgt)
        out.R.cpu()
        dt = (time.perf_counter() - t0) / stream
        best = dt if best is None else min(best, dt)
    pairs_per_sec = batch / best
    return {
        "metric": METRIC,
        "value": round(pairs_per_sec, 3),
        "unit": "pairs/s",
        "vs_baseline": round(pairs_per_sec / BASELINE_PAIRS_PER_SEC, 2),
        "first_call_s": first,
        "latency_ms": [x * 1e3 for x in times],
        "stream_ms": best * 1e3,
        "calls": 1 + max(warmup - 1, 0) + iters + 1 + 3 * stream,
        "registrar": reg, "src": src, "tgt": tgt, "out": out,
    }


def main(argv=None) -> dict:
    p = argparse.ArgumentParser()
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--batch", type=int, default=1)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--warmup", type=int, default=2)
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    args = p.parse_args(argv)
    res = run(args.num_points, args.batch, args.iters, args.warmup,
              device="cpu" if args.cpu else "cuda")
    line = {k: res[k] for k in ("metric", "value", "unit", "vs_baseline")}
    print(json.dumps(line))
    return line


if __name__ == "__main__":
    main()
