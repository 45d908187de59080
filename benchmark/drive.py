"""The load: closed loops over the pool's batches through the port's
Registrar, as a traffic file's "entry" names them.

- "call": one caller; each call is one batch through Registrar.__call__ and
  the harness's one copy of its pose (R and t) to the host, timed from its
  issue until that copy has landed.
- "stream": Registrar.stream over the batches with `depth` calls in flight;
  each output's pose is copied to the host as the stream yields it, and the
  pairs whose pose landed by the deadline count.

Both issue calls while the clock is before the deadline (or up to a count),
cycling through the pool, and hand every output to `keep` (a Reservoir).
"""

from __future__ import annotations

import time
from typing import Callable, List, NamedTuple, Optional

import numpy as np
import torch

from benchmark.trace import span

OUTPUTS = ("R", "t", "keypoints", "vcps", "saliency", "scores")


class Window(NamedTuple):
    calls: List[int]        # the batch index of each call whose pose landed in the window
    issued: int             # calls issued
    latencies_s: List[float]  # per call ("call" entry only)
    wall_s: float           # from the start to the last pose that counted
    failed: int             # pairs whose pose came back not finite


class Reservoir:
    """A uniform sample of `k` calls of all those offered, drawn from the
    seed (reservoir sampling), each kept as (batch index, outputs)."""

    def __init__(self, k: int, seed: int):
        self.k = k
        self.rng = np.random.default_rng((seed, 7))
        self.seen = 0
        self.items: list = []

    def offer(self, batch: int, out) -> None:
        item = (batch, {name: getattr(out, name) for name in OUTPUTS})
        if len(self.items) < self.k:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.k:
                self.items[j] = item
        self.seen += 1


def pose_to_host(out, B: int) -> int:
    """Copy the call's pose (R, t) to the host; return how many of its
    pairs' poses are not finite."""
    with span("pose_copy"):
        pose = torch.cat([out.R.reshape(B, 9), out.t], dim=1).cpu()
    return int((~torch.isfinite(pose)).any(dim=1).sum())


def call_loop(reg, batches, seconds: float, keep: Callable, limit: Optional[int] = None,
              first: int = 0) -> Window:
    B = batches[0][0].shape[0]
    lat, calls, failed = [], [], 0
    start = time.perf_counter()
    deadline = start + seconds
    i = 0
    while (limit is None or i < limit) and time.perf_counter() < deadline:
        b = (first + i) % len(batches)
        issued = time.perf_counter()
        with span("call"):
            out = reg(*batches[b])
            failed += pose_to_host(out, B)
        done = time.perf_counter()
        lat.append(done - issued)
        calls.append(b)
        keep(b, out)
        i += 1
    wall = (time.perf_counter() - start) if calls else 0.0
    return Window(calls, i, lat, wall, failed)


def stream_loop(reg, batches, seconds: float, depth: int, keep: Callable,
                limit: Optional[int] = None, first: int = 0) -> Window:
    B = batches[0][0].shape[0]
    issued = []
    start = time.perf_counter()
    deadline = start + seconds

    def feed():
        while (limit is None or len(issued) < limit) and time.perf_counter() < deadline:
            b = (first + len(issued)) % len(batches)
            issued.append(b)
            yield batches[b]

    calls, last, failed = [], start, 0
    for j, out in enumerate(reg.stream(feed(), depth)):
        failed += pose_to_host(out, B)
        done = time.perf_counter()
        if done <= deadline:
            calls.append(issued[j])
            last = done
        keep(issued[j], out)
    # the rate counts the pairs landed by the deadline over the time they
    # took to land: whole calls of B pairs land, so the window's own length
    # would round the rate to a multiple of B / seconds
    return Window(calls, len(issued), [], last - start, failed)


def run(reg, batches, traffic: dict, seconds: float, keep: Callable,
        limit: Optional[int] = None, first: int = 0) -> Window:
    if traffic["entry"] == "call":
        return call_loop(reg, batches, seconds, keep, limit, first)
    if traffic["entry"] == "stream":
        return stream_loop(reg, batches, seconds, int(traffic["depth"]), keep, limit, first)
    raise ValueError(f"unknown entry {traffic['entry']!r}")
