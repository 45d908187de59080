"""Small CPU runs of the harness for the tests: a cell's files with the
point count, the pool and the call counts cut so that the plain path runs
here in seconds; and a registry cascade written as a stages configuration."""

from __future__ import annotations

import copy
import dataclasses
import json

import torch

from benchmark import check, manifest, run

N_POINTS = 128


def cut(config: dict, traffic: dict, num_points: int = N_POINTS):
    """The configuration and traffic cut to run on the CPU: every stage at
    `num_points`, a pool of two calls, one warm-up call, two checked and
    two traced calls."""
    config, traffic = copy.deepcopy(config), dict(traffic)
    for stage in manifest.stages(config):
        stage["model"]["num_points"] = num_points
    traffic.update(pool=2 * traffic["batch"], warmup_calls=1, check_calls=2, trace_calls=2)
    return config, traffic


def small_cell(cell: str, num_points: int = N_POINTS):
    """(config, traffic, reported) of `cell`, cut to run on the CPU."""
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    config, traffic = cut(manifest.config(bench, w["config"]), manifest.traffic(w["traffic"]),
                          num_points)
    return config, traffic, manifest.reported(bench, cell)


def registry_cascade(name: str = "kitti-cascade", num_points: int = 10000,
                     like: str = "kitti25-rot") -> dict:
    """The registry cascade `name` (pretrained.CASCADES) as a stages
    configuration: each stage the registry checkpoint's config (its
    `.arch.json` applied) at `num_points`, its exported weights, and the
    registrar settings of configuration `like` (pretrained.cascade's: saliency
    weights, the guard, inlier ratio 0.8) with the cascade entry's
    refine_iters; the shared keys (source, precision, reduced, limits) of
    `like`, the reference benchmark/reference/cascade.py."""
    from deepvcp_tpu_torch import pretrained

    config = copy.deepcopy(manifest.config(manifest.load(), like))
    registrar = config["registrar"]
    for key in ("checkpoint", "weights", "model", "registrar"):
        config.pop(key)
    stages = []
    for stage, iters in pretrained.CASCADES[name]["stages"]:
        model = dataclasses.asdict(pretrained.config(stage, num_points=num_points))
        stages.append({"name": stage,
                       "checkpoint": f"deepvcp_tpu_torch/pretrained.py REGISTRY[{stage!r}] "
                                     f"({pretrained.REGISTRY[stage]['path']})",
                       "weights": f"deepvcp_tpu_torch/weights/{stage}.npz",
                       "model": json.loads(json.dumps(model)),
                       "registrar": dict(registrar, refine_iters=iters)})
    config.update(name=name, about=f"pretrained.cascade({name!r})",
                  reference="benchmark/reference/cascade.py", stages=stages)
    return config


def cpu_run(cell: str, seed: int = 2 ** 33 + 17, seconds: float = 0.2, trace: bool = False,
            limits=None, config=None) -> dict:
    """One harness run of the cut cell on the CPU (execute, past the
    card check), with `limits` (default: every number held to 1e-6); with
    `config`, that configuration (cut) under the cell's traffic."""
    small, traffic, reported = small_cell(cell)
    config = small if config is None else cut(config, traffic)[0]
    config["limits"] = limits or {name: 1e-6 for name in check.NUMBERS}
    torch.set_num_threads(4)
    return run.execute(config, traffic, seed, seconds, trace, torch.device("cpu"), reported)
