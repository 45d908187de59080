"""Multi-process setup (port of deepvcp_tpu/parallel/multihost.py): one
torch.distributed process group over every rank of the run, then the
("data", "point") mesh of parallel/mesh.py over it.

Call `initialize_multihost(..., device=...)` once at program start, in every
process, before anything touches the card. On "cuda" it binds the process to
its rank's card (rank_device: one card a rank, by local rank) before the
group exists, so NCCL's communicator and every later "cuda" tensor of the
rank land there. Data loading uses the data rank with
`data.batch_iterator(..., host_id=..., num_hosts=...)` so that each data
rank reads a disjoint stride of the index stream.
"""

from __future__ import annotations

import datetime
import os
import socket
import warnings
from typing import Optional, Tuple

import torch
import torch.distributed as dist

# torchrun's (and most launchers') rendezvous variables for init_method="env://"
_LAUNCHER_ENV = ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK")

# the card initialize_multihost bound this process to (None: none chosen)
_card: Optional[torch.device] = None


def backend_for(device) -> str:
    """The process group backend of a device: NCCL for the card, gloo for
    the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def rank_device(device, local_rank: Optional[int] = None) -> torch.device:
    """The device of a rank: for "cuda" (no index), card local_rank %
    device_count, the local rank taken from LOCAL_RANK (torchrun's variable)
    where that is set, else from `local_rank` (default 0); a card named with
    an index is that card; "cpu" is the CPU."""
    device = torch.device(device)
    if device.type != "cuda" or device.index is not None:
        return device
    count = torch.cuda.device_count()
    if count == 0:
        raise RuntimeError("rank_device('cuda'): no CUDA card is visible")
    if "LOCAL_RANK" in os.environ:
        local_rank = int(os.environ["LOCAL_RANK"])
    return torch.device("cuda", (local_rank or 0) % count)


def bound_card() -> Optional[torch.device]:
    """The card initialize_multihost bound this process to, or None."""
    return _card


def _local_host(address: Optional[str]) -> bool:
    """Whether a coordinator "host[:port]" is this machine."""
    host = (address or "").rsplit(":", 1)[0].strip("[]")
    return host in ("localhost", "::1", socket.gethostname()) or host.startswith("127.")


def _bind_card(device, backend: str, world_size: Optional[int], rank: Optional[int],
               coordinator: Optional[str]) -> Optional[torch.device]:
    """Make this rank's card (rank_device) the current one, ahead of
    init_process_group; returns it (None on the CPU). An NCCL group takes
    one card a rank: more ranks on this host than cards raises RuntimeError.
    The ranks on this host are LOCAL_WORLD_SIZE where set, else the world
    size when the coordinator is this host (unknown otherwise: no check).
    gloo ranks may share a card."""
    global _card
    if torch.device(device).type != "cuda":
        return None
    count = torch.cuda.device_count()
    local_world = os.environ.get("LOCAL_WORLD_SIZE")
    if local_world is None and _local_host(coordinator):
        local_world = world_size
    if backend == "nccl" and local_world is not None and int(local_world) > count:
        raise RuntimeError(
            f"an NCCL group takes one card a rank, but {local_world} ranks on this host "
            f"see {count} card(s): NCCL refuses two ranks on one device (use fewer ranks, "
            f"or backend='gloo' to share a card)")
    card = rank_device(device, rank)
    torch.cuda.set_device(card)
    _card = card
    return card


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
    its own (an NCCL failure is not retried over gloo). On "cuda" the
    process is first bound to its rank's card (torch.cuda.set_device of
    rank_device, the local rank LOCAL_RANK or else this process's rank), and
    NCCL gets it as `device_id`, which binds its communicator to that card;
    an NCCL group with more ranks on this host than cards raises
    RuntimeError (_bind_card), whatever the arguments. `timeout_s` bounds
    the rendezvous and every collective after it."""
    if dist.is_initialized():
        return dist.get_world_size() > 1
    explicit = any(a is not None for a in (coordinator_address, num_processes, process_id))
    backend = backend or backend_for(device)
    timeout = datetime.timedelta(seconds=timeout_s)
    missing = [k for k in _LAUNCHER_ENV if k not in os.environ]
    if not explicit and missing:
        warnings.warn(f"multi-process auto-initialisation unavailable (no launcher environment: "
                      f"{', '.join(missing)} unset); continuing single-process", stacklevel=2)
        return False
    if explicit:
        card = _bind_card(device, backend, num_processes, process_id, coordinator_address)
    else:
        card = _bind_card(device, backend, int(os.environ["WORLD_SIZE"]),
                          int(os.environ["RANK"]), os.environ["MASTER_ADDR"])
    bind = {"device_id": card} if backend == "nccl" and card is not None else {}
    try:
        if explicit:
            dist.init_process_group(backend, init_method=f"tcp://{coordinator_address}",
                                    world_size=num_processes, rank=process_id, timeout=timeout,
                                    **bind)
        else:
            dist.init_process_group(backend, init_method="env://", timeout=timeout, **bind)
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
