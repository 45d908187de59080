"""What a run hands the metric readers (benchmark/metrics/<name>.py): one
`Run` with the set-up time, the measured window, and with `--trace 1` the
traced window, its reduced trace and the work counts of the pool's pairs.
A reader returns None where its run holds nothing for it to read."""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

from benchmark import work
from benchmark.drive import Window
from benchmark.trace import Trace


@dataclass
class Run:
    config: dict
    traffic: dict
    setup_s: float
    window: Window                    # the measured window (untraced)
    peak_bytes: int                   # max_memory_allocated over the measured window
    pairs: List[List[int]]            # the pool's pairs of each batch
    traced: Optional[Window] = None   # the traced window (--trace 1)
    trace: Optional[Trace] = None
    pool_work: Optional[dict] = None  # work.pool_work of the pool (--trace 1)

    @property
    def batch(self) -> int:
        return int(self.traffic["batch"])

    def flops(self, calls: List[int]) -> Optional[float]:
        """The operations of these calls (batch indices), or None without
        the work counts."""
        if self.pool_work is None:
            return None
        f = self.pool_work["flops"]
        return float(sum(f[p] for b in calls for p in self.pairs[b]))

    def band_max_bound_ms(self, calls: List[int]) -> Optional[float]:
        if self.pool_work is None:
            return None
        f = self.pool_work["band_max_bound_ms"]
        return float(sum(f[p] for b in calls for p in self.pairs[b]))

    def mfu_pct(self) -> Optional[float]:
        """The model operations of the measured window's counted calls over
        its wall time at the card's f32 peak, in %."""
        ops = self.flops(self.window.calls)
        if ops is None or self.window.wall_s <= 0:
            return None
        return 100.0 * ops / (self.window.wall_s * work.PEAK_F32_FLOPS)

    def per_traced_call(self, ms: Optional[float]) -> Optional[float]:
        if ms is None or self.traced is None or not self.traced.calls:
            return None
        return ms / len(self.traced.calls)
