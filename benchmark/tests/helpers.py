"""Small CPU runs of the harness for the tests: a cell's files with the
point count, the pool and the call counts cut so that the plain path runs
here in seconds."""

from __future__ import annotations

import copy

import torch

from benchmark import check, manifest, run

N_POINTS = 128


def small_cell(cell: str, num_points: int = N_POINTS):
    """(config, traffic, reported) of `cell`, cut to run on the CPU."""
    bench = manifest.load()
    w = manifest.workload(bench, cell)
    config = copy.deepcopy(manifest.config(bench, w["config"]))
    traffic = dict(manifest.traffic(w["traffic"]))
    config["model"]["num_points"] = num_points
    traffic.update(pool=2 * traffic["batch"], warmup_calls=1, check_calls=2, trace_calls=2)
    return config, traffic, manifest.reported(bench, cell)


def cpu_run(cell: str, seed: int = 2 ** 33 + 17, seconds: float = 0.2, trace: bool = False,
            limits=None) -> dict:
    """One harness run of the cut cell on the CPU (execute, past the
    card check), with `limits` (default: every number held to 1e-6)."""
    config, traffic, reported = small_cell(cell)
    config["limits"] = limits or {name: 1e-6 for name in check.NUMBERS}
    torch.set_num_threads(4)
    return run.execute(config, traffic, seed, seconds, trace, torch.device("cpu"), reported)
