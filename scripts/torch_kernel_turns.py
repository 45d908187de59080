#!/usr/bin/env python3
"""Kernels K1 (banded_masked_max), K2 (banded_masked_max_grad) and K3
(farthest_point_sample) of the PyTorch port, the kitti25-rot registrar that
runs K1 and its train step that runs K1 and K2, timed in turns against
another tree's on one CUDA card.

    python3 scripts/torch_kernel_turns.py --other DIR [--rounds 4]

DIR holds another checkout of the repository (for instance the parent
commit, unpacked with `git archive`). Each round starts one worker process
per tree, in turns (this, other, other, this, ...); a worker imports the
port from its own tree (which builds its own kernels) and times, with CUDA
events around each call:
  K1  at the serving shapes (one FE pass of kitti25-rot: a 25 m lidar-like
      cloud, B = 1, N = 10 000, (C, r) = (16, 0.1), (32, 0.2), (64, 0.4))
      and at the cascade's (phase 13's held sets of chip_smoke.py, B = 2:
      lidar-like clouds of 1 m range and uniform cubes of extent 1, the
      same three (C, r));
  K2  at the same shapes, with the forward's output and Gaussian
      cotangents;
  K3  at one so3_global_init's two calls ([2, 10 000, 3] at npoint 4096
      and 128);
  the registrar, `pretrained.registrar("kitti25-rot")` on chip_smoke.py's
      first held pair: the median of 20 synced calls (host clock), after
      the kernels;
  the train step, kitti25-rot fine-tuned under the recipe that trained it
      (B = 1, chip_smoke.py's phase 8): the median of 10 synced steps and
      the device's busy time per step (torch.profiler, the union of the
      kernels' intervals over 3 steps), with chip_smoke.py's timers.
Each kernel is timed per call (the wrapper's host time included where it outlasts
the kernel, as chip_smoke.py's kernels line) and behind a device hold (the
device's time alone). Prints every round's numbers, then the medians over
the rounds and this tree's over the other's. Needs one card.
"""

from __future__ import annotations

import argparse
import importlib.util
import itertools
import json
import os
import statistics
import subprocess
import sys

HOLD_CYCLES = 20_000_000   # ~10 ms of the card's clock
SA_SHAPES = ((16, 0.1), (32, 0.2), (64, 0.4))
INIT_SHAPES = ((2, 10000, 4096), (2, 10000, 128))


def median_ms(torch, fn, reps: int, hold: bool) -> float:
    """Median CUDA-event time of fn() over reps calls, after 3 warm-up
    calls; with `hold`, enqueued behind a ~10 ms device sleep."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    if hold:
        torch.cuda._sleep(HOLD_CYCLES)
    pairs = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return statistics.median(s.elapsed_time(e) for s, e in pairs)


def smoke():
    """chip_smoke.py of this script's own tree, for its train recipe and
    timers (the worker's sys.path leads to the tree under test)."""
    path = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                        "chip_smoke.py")
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def train_step_fn(torch, dev, tcfg):
    """One fine-tuning step of kitti25-rot under the recipe tcfg, cycling
    over 4 clouds of chip_smoke.py's phase 8 data, as a function of no
    arguments."""
    from deepvcp_tpu_torch import convert, pretrained
    from deepvcp_tpu_torch.data import LidarLikeDataset, batch_iterator
    from deepvcp_tpu_torch.train import MetricsLogger, Trainer, build_train_step
    from deepvcp_tpu_torch.train.optim import learning_rate_schedule

    cfg, variables = pretrained.load("kitti25-rot", num_points=10000)
    trainer = Trainer(cfg, tcfg, device=dev, metrics=MetricsLogger(None, echo=False))
    trainer.setup()
    trainer.model.load_state_dict(convert.flax_to_torch(variables), strict=True)
    data = LidarLikeDataset(num_clouds=4, num_points=10000, max_range=25.0, seed=10)
    feed = itertools.cycle([tuple(torch.from_numpy(a).to(dev) for a in b)
                            for b in batch_iterator(data, 1, epoch=0, seed=0)])
    step_fn = build_train_step(trainer.model, learning_rate_schedule(tcfg), tcfg)

    def step():
        trainer.state, _ = step_fn(trainer.state, *next(feed))
    return step


def worker(tree: str) -> None:
    sys.path.insert(0, tree)
    import numpy as np
    import torch

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import (
        LidarLikeDataset, SyntheticDataset, batch_iterator, lidar_like_cloud)
    from deepvcp_tpu_torch.ops.kernels.band_max import banded_masked_max, banded_masked_max_grad
    from deepvcp_tpu_torch.ops.kernels.fps import farthest_point_sample

    dev = torch.device("cuda", 0)

    def sort_x(c):
        return c[np.argsort(c[:, 0], kind="stable")]

    serving = sort_x(lidar_like_cloud(np.random.default_rng(0), 10000, max_range=25.0))[None]
    sets = {
        "serving": serving,
        "cascade_lidar": LidarLikeDataset(num_clouds=2, num_points=10000, max_range=1.0,
                                          seed=103, noise_std=0.01),
        "cascade_cube": SyntheticDataset(num_clouds=2, num_points=10000, extent=1.0, seed=102,
                                         noise_std=0.01),
    }
    times = {}
    gen = torch.Generator(device=dev).manual_seed(0)
    for name, data in sets.items():
        if not isinstance(data, np.ndarray):
            src = next(batch_iterator(data, 2, epoch=0, seed=777, shuffle=False))[0]
            data = np.stack([sort_x(c[:, :3]) for c in src])
        x = torch.from_numpy(np.ascontiguousarray(data, dtype=np.float32)).to(dev)
        for C, r in SA_SHAPES:
            u = torch.randn(x.shape[0], x.shape[1], C, device=dev, generator=gen)
            fn = lambda: banded_masked_max(x, u, r)   # noqa: E731
            times[f"K1 {name} C={C} r={r}"] = [median_ms(torch, fn, 50, hold)
                                               for hold in (False, True)]
            out = banded_masked_max(x, u, r)
            g = torch.randn(u.shape, device=dev, generator=gen)
            fn = lambda: banded_masked_max_grad(x, u, out, g, r)   # noqa: E731
            times[f"K2 {name} C={C} r={r}"] = [median_ms(torch, fn, 50, hold)
                                               for hold in (False, True)]
    rng = np.random.default_rng(1)
    for B, N, k in INIT_SHAPES:
        x = torch.from_numpy(np.stack([lidar_like_cloud(rng, N, max_range=1.0)
                                       for _ in range(B)]).astype(np.float32)).to(dev)
        fn = lambda: farthest_point_sample(x, k)   # noqa: E731
        times[f"K3 [{B}, {N}, 3] npoint {k}"] = [median_ms(torch, fn, 10, hold)
                                                 for hold in (False, True)]
    reg = pretrained.registrar("kitti25-rot", device=dev)
    held = LidarLikeDataset(num_clouds=1, num_points=10000, max_range=25.0, seed=110,
                            max_rotation_deg=5.0, max_translation=0.5)
    src, tgt = (torch.from_numpy(a).to(dev)
                for a in next(batch_iterator(held, 1, epoch=0, seed=0, shuffle=False))[:2])
    cs = smoke()
    for _ in range(3):
        reg(src, tgt)
    times["registrar kitti25-rot"] = [cs.host_median_ms(torch, lambda: reg(src, tgt), 20)] * 2
    step = train_step_fn(torch, dev, cs.kitti25_recipe())
    for _ in range(3):
        step()
    times["train step kitti25-rot"] = [cs.host_median_ms(torch, step, 10),
                                       cs.device_time_per_call(torch, step, 3)[0]]
    print(json.dumps(times))


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--other", help="root of the other tree")
    ap.add_argument("--rounds", type=int, default=4)
    ap.add_argument("--worker", help=argparse.SUPPRESS)
    args = ap.parse_args()
    if args.worker:
        worker(os.path.abspath(args.worker))
        return
    if not args.other:
        ap.error("--other DIR is required")
    import torch

    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    trees = {"this": os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
             "other": os.path.abspath(args.other)}
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[0]
    print(f"card: {card}")
    runs = {name: [] for name in trees}
    for r in range(args.rounds):
        for name in (list(trees) if r % 2 == 0 else list(trees)[::-1]):
            proc = subprocess.run([sys.executable, os.path.abspath(__file__), "--worker",
                                   trees[name]], cwd=trees[name], capture_output=True, text=True)
            if proc.returncode != 0:
                sys.exit(f"worker of {name} failed:\n{proc.stderr[-4000:]}")
            runs[name].append(json.loads(proc.stdout.strip().splitlines()[-1]))
            print(f"round {r} {name}: " + json.dumps(runs[name][-1]), flush=True)
    print(f"medians over {args.rounds} rounds (ms per call | behind a hold; the registrar: "
          f"synced latency, twice; the train step: synced time | device busy time), {card}:")
    for key in runs["this"][0]:
        this = [statistics.median(t[key][i] for t in runs["this"]) for i in (0, 1)]
        other = [statistics.median(t[key][i] for t in runs["other"]) for i in (0, 1)]
        print(f"  {key}: this {this[0]:.4f} | {this[1]:.4f}, other {other[0]:.4f} | "
              f"{other[1]:.4f}, this / other {this[0] / other[0]:.3f} | {this[1] / other[1]:.3f}")
    # per serving FE pass (the three K1 shapes), per serving backward pass
    # (the three K2 shapes) and per init (the two K3 calls): each round's
    # sum, then the median over the rounds
    for what, prefix in (("K1 per serving FE pass", "K1 serving"),
                         ("K2 per serving backward pass", "K2 serving"), ("K3 per init", "K3")):
        this, other = ([statistics.median(sum(v[i] for k, v in t.items() if k.startswith(prefix))
                                          for t in runs[name]) for i in (0, 1)]
                       for name in ("this", "other"))
        print(f"  {what}: this {this[0]:.4f} | {this[1]:.4f}, other {other[0]:.4f} | "
              f"{other[1]:.4f}, this / other {this[0] / other[0]:.3f} | {this[1] / other[1]:.3f}")


if __name__ == "__main__":
    main()
