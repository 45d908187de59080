"""Run a function in several processes, one rank each, joined in one
process group: the local launcher of the port's multi-process paths (the
JAX package runs them from one controller over a virtual device mesh).

    results = run_ranks("package.module:function", world_size=4,
                        kwargs={...}, device="cpu", timeout_s=120)

Each rank is a fresh interpreter (`python -m deepvcp_tpu_torch.parallel.launch
SPEC`): it joins the group through initialize_multihost on a free localhost
port, calls function(**kwargs), and returns what it returns (pickled; keep
it on the CPU). CPU ranks share the host's cores equally. A rank that exits non-zero, or a run that outlasts its
timeout, kills every rank and raises with the ranks' output.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile
import time
from typing import Any, Dict, List, Optional, Sequence

_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def run_ranks(target: str, world_size: int, *, kwargs: Optional[Dict[str, Any]] = None,
              device: str, backend: Optional[str] = None, timeout_s: float = 120.0,
              sys_path: Sequence[str] = (), echo: bool = False) -> List[Any]:
    """Run `target` ("module:function") in `world_size` ranks over
    backend_for(device) (or `backend`); returns the ranks' results in rank
    order. With `echo`, print each rank's output, prefixed with its rank."""
    port = free_port()
    with tempfile.TemporaryDirectory(prefix="ranks_") as tmp:
        procs, logs = [], []
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [_ROOT, *sys_path] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
        for rank in range(world_size):
            spec = os.path.join(tmp, f"spec_{rank}.pkl")
            with open(spec, "wb") as fh:
                pickle.dump({"target": target, "rank": rank, "world_size": world_size,
                             "port": port, "device": device, "backend": backend,
                             "timeout_s": timeout_s, "kwargs": kwargs or {},
                             "out": os.path.join(tmp, f"out_{rank}.pkl")}, fh)
            log = open(os.path.join(tmp, f"log_{rank}.txt"), "w+")
            logs.append(log)
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "deepvcp_tpu_torch.parallel.launch", spec],
                stdout=log, stderr=subprocess.STDOUT, env=env, cwd=_ROOT))
        deadline = time.monotonic() + timeout_s
        fault = None
        try:
            while fault is None:
                codes = [p.poll() for p in procs]
                bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
                if bad:
                    fault = f"rank {bad[0]} exited with {codes[bad[0]]}"
                elif all(c == 0 for c in codes):
                    break
                elif time.monotonic() > deadline:
                    running = [r for r, c in enumerate(codes) if c is None]
                    fault = f"ranks {running} outlasted the {timeout_s:g} s timeout"
                else:
                    time.sleep(0.05)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
        texts = []
        for log in logs:
            log.seek(0)
            texts.append(log.read())
            log.close()
        if echo:
            for rank, text in enumerate(texts):
                for line in text.splitlines():
                    print(f"[rank {rank}] {line}", flush=True)
        if fault is not None:
            detail = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n{t[-4000:]}"
                               for r, (p, t) in enumerate(zip(procs, texts)))
            raise RuntimeError(f"{target} over {world_size} ranks: {fault}\n{detail}")
        results = []
        for rank in range(world_size):
            with open(os.path.join(tmp, f"out_{rank}.pkl"), "rb") as fh:
                results.append(pickle.load(fh))
        return results


def _rank_main(spec_path: str) -> None:
    import importlib

    import torch
    import torch.distributed as dist

    from deepvcp_tpu_torch.parallel.multihost import initialize_multihost

    with open(spec_path, "rb") as fh:
        spec = pickle.load(fh)
    if spec["device"] == "cpu":
        # the ranks share the host's cores
        torch.set_num_threads(max(1, (os.cpu_count() or 1) // spec["world_size"]))
    initialize_multihost(f"localhost:{spec['port']}", spec["world_size"], spec["rank"],
                         device=spec["device"], backend=spec["backend"],
                         timeout_s=spec["timeout_s"])
    try:
        module, name = spec["target"].split(":")
        result = getattr(importlib.import_module(module), name)(**spec["kwargs"])
        with open(spec["out"], "wb") as fh:
            pickle.dump(result, fh)
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _rank_main(sys.argv[1])
