"""The program's own spans in the traced window: the port's `deepvcp.*`
ranges (deepvcp_tpu_torch/utils/profiling.annotate), which torch.profiler
records while it runs, in the same session and on the same clock as the
device's activities. They are user annotations without the bench. prefix,
so benchmark/trace.py's Trace keeps them among its CPU events.

Everything here reads one Trace: its CPU events (ops, runtime calls and the
program's spans, all from the one issuing thread, so they nest), its device
activities with their launch times, and its idle gaps.

- A sync is a runtime call of trace.SYNCS; it is inside a span when the span
  is open at its start.
- A wait is a sync or a copy between the card and pageable host memory (a
  cudaMemcpy* call whose copy the trace names "... Pageable ..."): such a
  copy returns only once the work queued before it has run, so the host
  waits inside it, and the sync torch calls after it finds nothing left.
- A launch is a kernel launch call (LAUNCHES).
- `wait_ns(name)`: the time of the waits inside the name's spans;
  `span_ns(name)`: the time in the spans themselves. A registrar call's host
  time less its waits is its issue: Python, dispatch and launches.
- `exposed_idle_ns(name)`: the device idle of the gaps in which a sync inside
  the name's spans returned: the device ran dry while the host waited, and
  stays idle until the host has issued the next work.
- `census(trace)`: for each span name, per traced call: instances, host
  time, self host time, syncs, launches, the device time of the work
  launched inside it, and the idle of the gaps whose middle it is the
  innermost span open at. `sync_sites(trace)`: the syncs by innermost span
  and the ops around them. Neither is a metric: printed for PERF.md.
"""

from __future__ import annotations

import bisect
import collections
from typing import Dict, List, Optional, Tuple

from benchmark.trace import SYNCS

PREFIX = "deepvcp."
REGISTER = PREFIX + "register"
SOLVE = PREFIX + "solve"
DRAIN = PREFIX + "drain"
LAUNCHES = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel", "cuLaunchKernelEx")
OUTSIDE = "-"   # no program span open
CENSUS = ("n", "host_ms", "self_ms", "syncs", "wait_ms", "launches", "device_ms", "idle_ms")


class Spans:
    """The nesting of one trace's CPU events, and the program's spans in it."""

    def __init__(self, trace):
        self.trace = trace
        self.events = sorted(((s, e, name) for s, e, name, _ in trace.cpu),
                             key=lambda x: (x[0], -x[1]))
        self.starts = [s for s, _, _ in self.events]
        self.parent: List[int] = []
        stack: List[int] = []
        for i, (s, _, _) in enumerate(self.events):
            while stack and self.events[stack[-1]][1] <= s:
                stack.pop()
            self.parent.append(stack[-1] if stack else -1)
            stack.append(i)
        self.syncs = [i for i, (_, _, n) in enumerate(self.events) if n in SYNCS]
        # the device copy of each copy call, by the call's start (its launch time)
        self.copies = {launched: name for _, _, name, launched in trace.device
                       if name.startswith("Memcpy")}
        self.waits = [i for i, (s, _, n) in enumerate(self.events) if n in SYNCS or (
            n.startswith("cudaMemcpy") and "Pageable" in self.copies.get(s, ""))]

    def has(self, name: str) -> bool:
        return any(n == name for _, _, n in self.events)

    def innermost(self, t: int) -> int:
        """The index of the innermost event open at t (-1 for none)."""
        i = bisect.bisect_right(self.starts, t) - 1
        while i >= 0 and not t < self.events[i][1]:
            i = self.parent[i]
        return i

    def enclosing(self, i: int) -> List[int]:
        """The events around event i, innermost first."""
        out = []
        i = self.parent[i]
        while i >= 0:
            out.append(i)
            i = self.parent[i]
        return out

    def _span_names(self, indices: List[int]) -> List[str]:
        return [self.events[j][2] for j in indices if self.events[j][2].startswith(PREFIX)]

    def around(self, i: int) -> List[str]:
        """The names of the program spans around event i, innermost first."""
        return self._span_names(self.enclosing(i))

    def open_at(self, t: int) -> List[str]:
        """The names of the program spans open at t, innermost first."""
        i = self.innermost(t)
        return self._span_names([i] + self.enclosing(i)) if i >= 0 else []

    def span_ns(self, name: str) -> int:
        return sum(e - s for s, e, n in self.events if n == name)

    def _in(self, indices: List[int], name: str) -> List[Tuple[int, int, str]]:
        return [self.events[i] for i in indices if name in self.around(i)]

    def sync_count(self, name: str) -> int:
        return len(self._in(self.syncs, name))

    def wait_ns(self, name: str) -> int:
        return sum(e - s for s, e, _ in self._in(self.waits, name))

    def exposed_idle_ns(self, name: str) -> int:
        returns = sorted(e for _, e, _ in self._in(self.syncs, name))
        total = 0
        for a, b in self.trace.gaps:
            k = bisect.bisect_left(returns, a)
            if k < len(returns) and returns[k] <= b:
                total += b - a
        return total


def program_spans(run) -> Optional[Spans]:
    """The spans of the run's traced window, or None where it has no
    deepvcp.register span (no trace, or a program without spans)."""
    if run.trace is None or not run.trace.calls:
        return None
    spans = Spans(run.trace)
    return spans if spans.has(REGISTER) else None


def per_call_ms(run, ns: float) -> float:
    return ns / 1e6 / run.trace.calls


def census(trace) -> Dict[str, Dict[str, float]]:
    """For each span name (and OUTSIDE: no span open), per traced call: n
    (instances), host_ms, self_ms (less its child spans), syncs, wait_ms,
    launches (these three inclusive of child spans), device_ms (launched
    inside it, inclusive), idle_ms (gaps whose middle it is the innermost
    span open at)."""
    sp = Spans(trace)
    rows: Dict[str, Dict[str, float]] = collections.defaultdict(lambda: dict.fromkeys(
        CENSUS, 0.0))
    for i, (s, e, name) in enumerate(sp.events):
        if name.startswith(PREFIX):
            rows[name]["n"] += 1
            rows[name]["host_ms"] += e - s
            rows[name]["self_ms"] += e - s
            up = sp.around(i)
            if up:
                rows[up[0]]["self_ms"] -= e - s
        elif name in SYNCS or name in LAUNCHES:
            for span in set(sp.around(i)) or {OUTSIDE}:
                rows[span]["syncs" if name in SYNCS else "launches"] += 1
    for i in sp.waits:
        s, e, _ = sp.events[i]
        for span in set(sp.around(i)) or {OUTSIDE}:
            rows[span]["wait_ms"] += e - s
    for start, end, _, launched in trace.device:
        if launched is not None:
            for span in set(sp.open_at(launched)) or {OUTSIDE}:
                rows[span]["device_ms"] += end - start
    for a, b in trace.gaps:
        rows[(sp.open_at((a + b) // 2) or [OUTSIDE])[0]]["idle_ms"] += b - a
    calls = trace.calls or 1
    out = {}
    for name, row in sorted(rows.items()):
        out[name] = {k: (v / 1e6 if k.endswith("_ms") else v) / calls for k, v in row.items()}
    return out


def sync_sites(trace) -> Dict[Tuple[str, str, str], float]:
    """The syncs per traced call by (innermost span, the outermost op under
    it, the innermost op around the sync)."""
    sp = Spans(trace)
    sites = collections.Counter()
    for i in sp.syncs:
        ops = []
        span = OUTSIDE
        for j in sp.enclosing(i):
            name = sp.events[j][2]
            if name.startswith(PREFIX):
                span = name
                break
            ops.append(name)
        sites[(span, ops[-1] if ops else OUTSIDE, ops[0] if ops else OUTSIDE)] += 1
    calls = trace.calls or 1
    return {k: v / calls for k, v in sites.most_common()}


def runtime_calls(trace) -> Dict[Tuple[str, str], Tuple[float, float, float]]:
    """The CUDA runtime and driver calls (names starting "cu") per traced
    call by (innermost span, name, with a copy's device kind): (calls, ms,
    the longest one's ms), the most time first."""
    sp = Spans(trace)
    calls = collections.defaultdict(lambda: [0, 0, 0])
    for i, (s, e, name) in enumerate(sp.events):
        if name.startswith("cu"):
            kind = sp.copies.get(s)
            row = calls[((sp.around(i) or [OUTSIDE])[0], f"{name} [{kind}]" if kind else name)]
            row[0] += 1
            row[1] += e - s
            row[2] = max(row[2], e - s)
    n = trace.calls or 1
    return {k: (c / n, ns / 1e6 / n, top / 1e6)
            for k, (c, ns, top) in sorted(calls.items(), key=lambda kv: -kv[1][1])}
