"""Multi-process training and solves of the port (counterpart of
deepvcp_tpu/parallel): the ("data", "point") mesh over a torch.distributed
process group, process-group setup, heartbeats and the stall watchdog, and
a local launcher for runs of several ranks (launch.run_ranks)."""

from deepvcp_tpu_torch.parallel.heartbeat import (
    Heartbeat,
    PeerFailure,
    Watchdog,
    check_peers,
    wait_for_all_hosts,
)
from deepvcp_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    POINT_AXIS,
    batch_pair_sharding,
    make_mesh,
    replicated,
    shard_batch,
)
from deepvcp_tpu_torch.parallel.multihost import (
    host_shard_info,
    initialize_multihost,
    is_primary_host,
    rank_device,
)

__all__ = [
    "DATA_AXIS",
    "POINT_AXIS",
    "make_mesh",
    "batch_pair_sharding",
    "replicated",
    "shard_batch",
    "initialize_multihost",
    "rank_device",
    "Heartbeat",
    "Watchdog",
    "PeerFailure",
    "check_peers",
    "wait_for_all_hosts",
    "host_shard_info",
    "is_primary_host",
]
