"""The traced window (`--trace 1`): spans recorded from the benchmark's own
files around the calls into the port's layers, torch.profiler over the
window, and the reduction of its trace to what the per-layer readers take.

Spans: the model instance of each of the system's stages gets `encode`,
`correspond` and `candidate_neighbors` shadowed by instance attributes that
open a torch.profiler.record_function range ("bench.encode", ...) around the
original method, so that a range's time sums over the stages; the harness
opens "bench.window" around the traced window, "bench.call" around each call
and "bench.pose_copy" around its own copy of the pose to the host. Nothing
is installed with `--trace 0`.

Reduction, all from the one trace: the device's busy time is the union of
the intervals of every device activity (kernels, copies, fills; the
profiler's device-side ranges of the user annotations are left out), the
window is bench.window's range, the idle gaps are the holes in that union
inside the window, each labelled by the bench range and the innermost CPU op
or CUDA runtime call open at its middle. A range's device time is the sum of
the device activities whose launching runtime call (matched by correlation
id) falls inside one of that range's intervals. Host syncs are the
cudaStreamSynchronize, cudaDeviceSynchronize and cudaEventSynchronize calls
in the window.
"""

from __future__ import annotations

import bisect
import collections
import contextlib
from typing import Dict, List, Optional, Tuple

import torch

SPANS = ("encode", "correspond", "candidate_neighbors")
SYNCS = ("cudaStreamSynchronize", "cudaDeviceSynchronize", "cudaEventSynchronize")


def span(name: str):
    """A range named bench.<name> in the trace (a no-op context when no
    profiler runs)."""
    return torch.profiler.record_function(f"bench.{name}")


@contextlib.contextmanager
def spans(*models):
    """Within the block, each model instance's SPANS methods run inside their
    bench.* ranges; afterwards the class's methods are back."""
    for model in models:
        for name in SPANS:
            original = getattr(model, name)

            def wrapped(*args, _original=original, _name=name, **kwargs):
                with span(_name):
                    return _original(*args, **kwargs)

            setattr(model, name, wrapped)
    try:
        yield
    finally:
        for model in models:
            for name in SPANS:
                delattr(model, name)


def profiler():
    from torch.profiler import ProfilerActivity, profile

    return profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA])


class Trace:
    """The reduced trace of one profiled window."""

    def __init__(self, prof, calls: int):
        from torch.autograd import DeviceType

        self.calls = calls
        events = prof.profiler.kineto_results.events()
        device, cpu, ranges = [], [], collections.defaultdict(list)
        for e in events:
            start, end = e.start_ns(), e.start_ns() + e.duration_ns()
            if e.device_type() == DeviceType.CUDA:
                if not e.is_user_annotation():
                    device.append((start, end, e.name(), e.correlation_id(),
                                   e.linked_correlation_id()))
            elif e.is_user_annotation() and e.name().startswith("bench."):
                ranges[e.name()[len("bench."):]].append((start, end))
            else:
                cpu.append((start, end, e.name(), e.correlation_id()))
        if not ranges.get("window"):
            raise RuntimeError("the trace has no bench.window range")
        self.window = ranges["window"][0]
        self.ranges = {k: sorted(v) for k, v in ranges.items()}
        lo, hi = self.window
        self.cpu = sorted(c for c in cpu if c[1] > lo and c[0] < hi)
        self.syncs = sum(1 for c in self.cpu if c[2] in SYNCS)
        launch = {c[3]: c[0] for c in self.cpu if c[2].startswith("cu")}
        self.device = []   # (start, end, name, launch time or None)
        for start, end, name, corr, linked in device:
            if end <= lo or start >= hi:
                continue
            self.device.append((max(start, lo), min(end, hi), name,
                                launch.get(corr, launch.get(linked))))
        self.unlinked = sum(1 for d in self.device if d[3] is None)
        self.busy_ns, self.gaps = self._union()

    def _union(self) -> Tuple[int, List[Tuple[int, int]]]:
        busy, gaps = 0, []
        lo, hi = self.window
        reached = lo
        for start, end, *_ in sorted(self.device):
            if start > reached:
                gaps.append((reached, start))
            if end > reached:
                busy += end - max(start, reached)
                reached = end
        if hi > reached:
            gaps.append((reached, hi))
        return busy, gaps

    @property
    def window_s(self) -> float:
        return (self.window[1] - self.window[0]) / 1e9

    @property
    def busy_s(self) -> float:
        return self.busy_ns / 1e9

    def idle_share(self) -> Optional[float]:
        """1 - busy / window, or None where the device ran nothing."""
        return None if self.busy_ns == 0 else 1.0 - self.busy_ns / (self.window[1] - self.window[0])

    def range_device_ms(self, name: str) -> Optional[float]:
        """Device time (ms) of the activities launched inside the bench.<name>
        ranges; None where the range never opened or launched nothing."""
        intervals = self.ranges.get(name)
        if not intervals:
            return None
        starts = [s for s, _ in intervals]
        total, seen = 0, False
        for start, end, _, launched in self.device:
            if launched is None:
                continue
            i = bisect.bisect_right(starts, launched) - 1
            if i >= 0 and launched < intervals[i][1]:
                total += end - start
                seen = True
        return total / 1e6 if seen else None

    def kernel_ms(self, part: str) -> Optional[float]:
        """Device time (ms) of the kernels whose (demangled) name holds
        `part`, such as "band_max_kernel<" of "void band_max_kernel<16,
        4>(...)"; None where none ran."""
        times = [end - start for start, end, name, _ in self.device if part in name]
        return sum(times) / 1e6 if times else None

    def _open_at(self, t: int) -> str:
        """The bench range and the innermost CPU op or runtime call open at
        time t, as "range/op"."""
        where, latest = "window", None
        for name, intervals in self.ranges.items():
            for start, end in intervals:
                if name != "window" and start <= t < end and (latest is None or start > latest):
                    where, latest = name, start
        op = "python"
        best = None
        for start, end, name, _ in self.cpu:
            if start > t:
                break
            if end > t and (best is None or start >= best):
                best, op = start, name
        return f"{where}/{op}"

    def breakdown(self, top: int = 10) -> Dict[str, list]:
        """The device activities that took most time, by name, and the longest
        idle gaps, labelled, in seconds."""
        by_name = collections.Counter()
        for start, end, name, _ in self.device:
            by_name[name] += end - start
        ops = [[name[:120], ns / 1e9] for name, ns in by_name.most_common(top)]
        gaps = sorted(self.gaps, key=lambda g: g[0] - g[1])[:top]
        return {"device_ops": ops,
                "idle_gaps": [[self._open_at((a + b) // 2), (b - a) / 1e9] for a, b in gaps]}
