"""Multi-process failure detection: heartbeats and a stall watchdog (the
port's own copy of deepvcp_tpu/parallel/heartbeat.py, semantics unchanged:
that module imports no jax, but the port imports nothing of the JAX package).

The shared-filesystem protocol (the checkpoint directory is shared storage
for a multi-host run already, so no new infrastructure is assumed):

- every process runs a `Heartbeat` daemon thread that writes
  `heartbeat_<rank>.json` ({ts, step, process_id}) every `interval`
  seconds: host-side file I/O only, never a collective (a liveness probe
  through the process group from a side thread would race the training
  step's own collectives);
- `check_peers` reads every peer's file and classifies it as alive /
  stale / missing against a `stale_after` horizon;
- `Watchdog.scan()` is called from the training loop (once per epoch in
  `Trainer.fit`); on a stale peer it raises `PeerFailure` (the default:
  fail fast and let the job scheduler restart everyone, after which
  `Trainer.fit(..., resume=True)` continues from the last epoch
  checkpoint) or calls a user callback.

A run must never continue silently with a wedged peer, because the
collectives would simply hang; noticing the stall on the host and exiting
is what unwedges the job.
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Callable, Dict, Optional


class PeerFailure(RuntimeError):
    """A peer process missed its heartbeat horizon."""


def _hb_path(directory: str, process_id: int) -> str:
    return os.path.join(directory, f"heartbeat_{process_id}.json")


class Heartbeat:
    """Background heartbeat writer for this process.

    Usage:
        hb = Heartbeat(ckpt_dir, process_id=dist.get_rank())
        hb.start()
        ...
        hb.update(step)        # cheap; called from the train loop
        ...
        hb.stop()
    """

    def __init__(
        self,
        directory: str,
        process_id: int,
        interval: float = 10.0,
    ):
        self.directory = directory
        self.process_id = process_id
        self.interval = interval
        self._step = 0
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        os.makedirs(directory, exist_ok=True)

    def update(self, step: int) -> None:
        self._step = int(step)

    def _write(self) -> None:
        path = _hb_path(self.directory, self.process_id)
        tmp = path + ".tmp"
        with open(tmp, "w") as fh:
            json.dump({"ts": time.time(), "step": self._step,
                       "process_id": self.process_id}, fh)
        os.replace(tmp, path)  # atomic: readers never see partial JSON

    def _run(self) -> None:
        while not self._stop.is_set():
            try:
                self._write()
            except OSError:
                pass  # transient shared-FS hiccup; next beat retries
            self._stop.wait(self.interval)

    def start(self) -> "Heartbeat":
        if self._thread is None:
            self._write()  # beat once synchronously (startup barrier)
            self._thread = threading.Thread(
                target=self._run, daemon=True,
                name=f"heartbeat-{self.process_id}")
            self._thread.start()
        return self

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2 * self.interval)
            self._thread = None


def check_peers(
    directory: str,
    num_processes: int,
    stale_after: float = 60.0,
    now: Optional[float] = None,
) -> Dict[int, Dict]:
    """Classify every process: {"status": "alive"|"stale"|"missing",
    "age": seconds since last beat (None if missing), "step": ...}."""
    now = time.time() if now is None else now
    out: Dict[int, Dict] = {}
    for pid in range(num_processes):
        path = _hb_path(directory, pid)
        try:
            with open(path) as fh:
                rec = json.load(fh)
            age = now - rec["ts"]
            out[pid] = {
                "status": "stale" if age > stale_after else "alive",
                "age": age,
                "step": rec.get("step"),
            }
        except (OSError, ValueError, KeyError):
            out[pid] = {"status": "missing", "age": None, "step": None}
    return out


def wait_for_all_hosts(
    directory: str,
    num_processes: int,
    timeout: float = 300.0,
    poll: float = 1.0,
) -> None:
    """Startup barrier: block until every process has beaten once.
    Raises PeerFailure (naming the absentees) on timeout — a pod job
    with a host that never came up must fail loudly, not hang in the
    first collective."""
    t0 = time.time()
    while True:
        peers = check_peers(directory, num_processes,
                            stale_after=float("inf"))
        missing = [p for p, rec in peers.items()
                   if rec["status"] == "missing"]
        if not missing:
            return
        if time.time() - t0 > timeout:
            raise PeerFailure(
                f"processes {missing} never heartbeat within "
                f"{timeout:.0f}s of startup")
        time.sleep(poll)


class Watchdog:
    """Per-process stall detector, driven from the training loop.

    `scan()` is cheap (num_processes tiny file reads) — call it once
    per epoch or every N steps. Default action on a stale/missing peer
    is to raise PeerFailure; pass `on_failure` to customize (e.g. log
    and initiate a graceful checkpoint before exiting).

    Detects two distinct failure modes:
      - dead process / crashed host: the daemon thread dies with it, so
        the file's timestamp goes stale ("stale"/"missing");
      - wedged process (e.g. a peer hung inside a collective): its
        daemon thread keeps beating but `step` stops advancing —
        flagged "stalled" once the step hasn't moved for
        `step_stale_after` seconds (0 disables; set it comfortably
        above the slowest step/epoch granularity the caller updates
        at)."""

    def __init__(
        self,
        directory: str,
        num_processes: int,
        process_id: int,
        stale_after: float = 60.0,
        step_stale_after: float = 0.0,
        on_failure: Optional[Callable[[Dict[int, Dict]], None]] = None,
        grace_period: float = 0.0,
    ):
        self.directory = directory
        self.num_processes = num_processes
        self.process_id = process_id
        self.stale_after = stale_after
        self.step_stale_after = step_stale_after
        self.on_failure = on_failure
        self._armed_at = time.time() + grace_period
        self._progress: Dict[int, tuple] = {}  # pid -> (step, since)

    def scan(self) -> Dict[int, Dict]:
        now = time.time()
        peers = check_peers(
            self.directory, self.num_processes, self.stale_after, now=now)
        if self.step_stale_after > 0:
            for pid, rec in peers.items():
                if rec["status"] != "alive":
                    continue
                last = self._progress.get(pid)
                if last is None or rec["step"] != last[0]:
                    self._progress[pid] = (rec["step"], now)
                elif now - last[1] > self.step_stale_after:
                    rec["status"] = "stalled"
        if now < self._armed_at:
            return peers
        bad = {p: rec for p, rec in peers.items()
               if p != self.process_id and rec["status"] != "alive"}
        if bad:
            if self.on_failure is not None:
                self.on_failure(peers)
            else:
                raise PeerFailure(
                    f"peer processes unhealthy: "
                    f"{ {p: r['status'] for p, r in bad.items()} } — "
                    f"exit and restart the job; training resumes from "
                    f"the last epoch checkpoint (Trainer resume=True)")
        return peers
