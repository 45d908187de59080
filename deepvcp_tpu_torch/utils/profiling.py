"""Profiling and diagnostics (port of deepvcp_tpu/utils/profiling.py): named
stage ranges for torch.profiler traces, a per-stage latency report whose
clock is read after the stage's device has finished, and NaN checks."""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable, Dict, List, Tuple

import torch


def _synchronize(obj) -> None:
    """Wait for every CUDA device that `obj` (a device, a tensor, or a
    tuple, list or dict of them) lives on."""
    if isinstance(obj, torch.device):
        if obj.type == "cuda":
            torch.cuda.synchronize(obj)
    elif isinstance(obj, torch.Tensor):
        _synchronize(obj.device)
    elif isinstance(obj, dict):
        for v in obj.values():
            _synchronize(v)
    elif isinstance(obj, (tuple, list)):
        for v in obj:
            _synchronize(v)


class StageTimer:
    """Wall-clock latency per stage. Each stage synchronises the devices of
    its `sync` (a device or the stage's outputs) before the clock is read,
    so a stage's time includes its device work. Usage:

        timer = StageTimer()
        with timer.stage("fe", sync=device):
            feats = fe(...)
        ...
        print(timer.report())
    """

    def __init__(self):
        self.times: List[Tuple[str, float]] = []

    @contextlib.contextmanager
    def stage(self, name: str, sync=None):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            _synchronize(sync)
            self.times.append((name, time.perf_counter() - t0))

    def timeit(self, name: str, fn: Callable, *args, **kwargs):
        """Run fn, wait for its result's devices, record the latency and
        return the result."""
        t0 = time.perf_counter()
        out = fn(*args, **kwargs)
        _synchronize(out)
        self.times.append((name, time.perf_counter() - t0))
        return out

    def report(self) -> str:
        total = sum(t for _, t in self.times)
        lines = [f"{'stage':24s} {'ms':>10s} {'%':>6s}"]
        for name, t in self.times:
            pct = 100.0 * t / total if total else 0.0
            lines.append(f"{name:24s} {t * 1e3:10.2f} {pct:6.1f}")
        lines.append(f"{'total':24s} {total * 1e3:10.2f}")
        return "\n".join(lines)

    def as_dict(self) -> Dict[str, float]:
        return {name: t for name, t in self.times}


_NO_RANGE = contextlib.nullcontext()


def annotate(name: str):
    """A named range in torch.profiler traces (and in Nsight's, through
    the profiler's annotation): torch.profiler.record_function while a
    profiler records on this thread, else one shared no-op context. The
    serving path opens ~20 ranges a call; an unguarded record_function
    costs ~11 us each even with no profiler running, the check ~0.7 us."""
    if not torch.autograd._profiler_enabled():
        return _NO_RANGE
    return torch.profiler.record_function(name)


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a torch.profiler trace of the host and, where there is a
    card, its kernels; written to log_dir/trace.json (chrome://tracing,
    Perfetto) on exit. Yields the profiler."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


def enable_nan_checks(enable: bool = True) -> None:
    """NaN debugging: torch.autograd.set_detect_anomaly(enable,
    check_nan=True), the closest switch to jax_debug_nans. Every backward
    node's outputs are checked, and a NaN raises with the traceback of the
    forward operation that created the node. It does not catch what
    jax_debug_nans does in the forward: a NaN produced by a forward
    operation (under torch.no_grad, in serving, nothing is checked at all)
    is only found when its gradient is; and it slows autograd down."""
    torch.autograd.set_detect_anomaly(enable, check_nan=True)
