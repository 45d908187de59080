"""Multi-process setup (port of deepvcp_tpu/parallel/multihost.py): one
torch.distributed process group over every rank of the run, then the
("data", "point") mesh of parallel/mesh.py over it.

Call `initialize_multihost(..., device=...)` once at program start, in every
process. Data loading uses the data rank with
`data.batch_iterator(..., host_id=..., num_hosts=...)` so that each data
rank reads a disjoint stride of the index stream.
"""

from __future__ import annotations

import datetime
import os
import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# torchrun's (and most launchers') rendezvous variables for init_method="env://"
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")


def backend_for(device) -> str:
    """The process group backend of a device: NCCL for the card, gloo for
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_multihost(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    device,
    backend: Optional[str] = None,
    timeout_s: float = 300.0,
) -> bool:
    """Initialise the default process group; True when the run has more
    than one process. The JAX package's loud semantics:

    - EXPLICIT arguments (a coordinator "host:port", the world size or this
      process's rank): the caller declared a multi-process run, so any
      init_process_group failure RAISES RuntimeError;
    - no arguments: the launcher's environment (MASTER_ADDR, MASTER_PORT,
      WORLD_SIZE, RANK). Where there is none, or it does not initialise,
      warn with the cause and return False (one process, no group).

    The backend is backend_for(device) unless given; it never changes on
    its own (an NCCL failure is not retried over gloo). `timeout_s` bounds
    the rendezvous and every collective after it."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    backend = backend or backend_for(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    try:
        if explicit:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id, timeout=timeout)
        else:
            missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
            if missing:
                raise RuntimeError(f"no launcher environment ({', '.join(missing)} unset)")
            dist.init_process_group(backend, init_method="env://", timeout=timeout)
    except Exception as e:
        if explicit:
            raise RuntimeError(
                "init_process_group failed for an explicitly configured "
                f"multi-process run: {e!r}") from e
        warnings.warn(f"multi-process auto-initialisation unavailable ({e!r}); "
                      "continuing single-process", stacklevel=2)
        return False
    return dist.get_world_size() > 1


def host_shard_info() -> Tuple[int, int]:
    """(rank, world size) of this process; (0, 1) without a process group."""
    if not dist.is_initialized():
        return 0, 1
    return dist.get_rank(), dist.get_world_size()


def is_primary_host() -> bool:
    """Checkpoint and metrics writers run on rank 0 only."""
    return host_shard_info()[0] == 0
