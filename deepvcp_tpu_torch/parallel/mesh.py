"""The ("data", "point") mesh over the process group (port of
deepvcp_tpu/parallel/mesh.py).

A rank is one process with one device. The mesh lays the world out
row-major, rank = data_index * point + point_index, as the JAX package's
np.asarray(devices).reshape(data, point):

- frame pairs are split over "data": each data rank runs B / data pairs
  and the gradients are all-reduced over its data group;
- the ranks of one "point" group hold the same pairs. The candidate KNN
  runs as the ring over the point group (ops/distributed.ring_knn) when the
  model has a knn_mesh; the rest of their forward is computed redundantly
  (GSPMD partitions the per-point ops of the JAX step across chips, which
  the port does not: that costs memory, not results);
- parameters and optimizer state are replicated: broadcast from rank 0
  when the train step is built.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh, init_device_mesh
from torch.distributed.tensor import Replicate, Shard

DATA_AXIS = "data"
POINT_AXIS = "point"


def make_mesh(data: Optional[int] = None, point: int = 1, *, device) -> DeviceMesh:
    """A ("data", "point") DeviceMesh over every rank of the initialised
    process group (parallel.initialize_multihost), data * point == world
    size; data defaults to world size / point. `device` names the ranks'
    device type ("cuda" or "cpu")."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    world = dist.get_world_size()
    if data is None:
        assert world % point == 0, (world, point)
        data = world // point
    assert data * point == world, (data, point, world)
    return init_device_mesh(torch.device(device).type, (data, point),
                            mesh_dim_names=(DATA_AXIS, POINT_AXIS))


def axis_size(mesh: DeviceMesh, axis: str) -> int:
    return mesh.shape[mesh.mesh_dim_names.index(axis)]


def axis_index(mesh: DeviceMesh, axis: str) -> int:
    """This rank's index along `axis` (jax.lax.axis_index)."""
    return mesh.get_local_rank(axis)


def axis_group(mesh: DeviceMesh, axis: str):
    """The process group of the ranks that differ from this one only along
    `axis`."""
    return mesh.get_group(axis)


def axis_peers(mesh: DeviceMesh, axis: str) -> List[int]:
    """The global ranks of this rank's group along `axis`, in axis order."""
    index = list(mesh.get_coordinate())
    index[mesh.mesh_dim_names.index(axis)] = slice(None)
    return mesh.mesh[tuple(index)].tolist()


def all_gather_cat(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int) -> torch.Tensor:
    """The shards of every rank along `axis`, joined on `dim` in axis order
    (equal shapes). Not differentiable."""
    if axis_size(mesh, axis) == 1:
        return x
    parts = [torch.empty_like(x) for _ in range(axis_size(mesh, axis))]
    dist.all_gather(parts, x.contiguous(), group=axis_group(mesh, axis))
    return torch.cat(parts, dim=dim)


def shard_rows(x, mesh: DeviceMesh, axis: str = DATA_AXIS):
    """This rank's rows (axis 0) of `x`, split evenly over `axis`."""
    n = axis_size(mesh, axis)
    assert x.shape[0] % n == 0, (x.shape, axis, n)
    rows = x.shape[0] // n
    i = axis_index(mesh, axis)
    return x[i * rows:(i + 1) * rows]


def batch_pair_sharding(mesh: DeviceMesh) -> Tuple[Tuple, ...]:
    """The DTensor placements of a (src, tgt, R, t) batch over the mesh's
    (data, point) dims: pairs split over "data", replicated over "point"
    (the JAX package also splits the clouds' points over "point"; the port's
    point group shares its pairs, see the module docstring)."""
    pairs = (Shard(0), Replicate())
    return pairs, pairs, pairs, pairs


def replicated(mesh: DeviceMesh) -> Tuple:
    """The placements of the parameters and optimizer state."""
    return Replicate(), Replicate()


def shard_batch(mesh: DeviceMesh, batch: Sequence, local: bool = False) -> Tuple[torch.Tensor, ...]:
    """A (src, tgt, R, t) batch as this rank's tensors on its device, laid
    out by batch_pair_sharding: the rank's rows of the global batch (every
    rank passes the same batch). With `local`, `batch` is already this
    rank's rows, as each process loads them in a multi-process run
    (batch_iterator(host_id=data index, num_hosts=data size)), and is only
    moved to the device."""
    dev = torch.device("cuda", torch.cuda.current_device()) \
        if mesh.device_type == "cuda" else torch.device(mesh.device_type)
    out = []
    for a, placements in zip(batch, batch_pair_sharding(mesh)):
        t = a if isinstance(a, torch.Tensor) else torch.as_tensor(np.asarray(a))
        for axis, placement in zip(mesh.mesh_dim_names, placements):
            if isinstance(placement, Shard) and not local:
                assert placement.dim == 0, placement
                t = shard_rows(t, mesh, axis)
        out.append(t.to(dev))
    return tuple(out)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Replicate a module's parameters and buffers from global rank `src`
    to every rank."""
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            dist.broadcast(t.data, src)
