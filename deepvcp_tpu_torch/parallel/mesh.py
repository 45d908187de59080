"""The ("data", "point") mesh over the process group (port of
deepvcp_tpu/parallel/mesh.py).

A rank is one process with one device. The mesh lays the world out
row-major, rank = data_index * point + point_index, as the JAX package's
np.asarray(devices).reshape(data, point):

- frame pairs are split over "data": each data rank runs B / data pairs
  and the gradients are all-reduced over its data group;
- the ranks of one "point" group hold the same pairs, whole (sorting a
  cloud is one global op). Within the train step they split the per-point
  work as GSPMD splits the JAX step's: rank r of a group of P owns rows
  [r N / P, (r + 1) N / P) of each cloud (sorted along x, except on the
  dense engine) and keypoints
  [r K / P, (r + 1) K / P), and all-gathers what an op needs whole
  (point_shard / gather_points; models.point_partition). The candidate
  KNN runs as the ring over the point group (ops/distributed.ring_knn)
  when the model has a knn_mesh;
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

from deepvcp_tpu_torch.parallel.multihost import bound_card

DATA_AXIS = "data"
POINT_AXIS = "point"


def rank_card(device_type: str) -> torch.device:
    """This rank's device of `device_type`: on "cuda", the card that
    initialize_multihost bound the rank to, else the current card."""
    if device_type != "cuda":
        return torch.device(device_type)
    return bound_card() or torch.device("cuda", torch.cuda.current_device())


def make_mesh(data: Optional[int] = None, point: int = 1, *, device) -> DeviceMesh:
    """A ("data", "point") DeviceMesh over every rank of the initialised
    process group (parallel.initialize_multihost), data * point == world
    size; data defaults to world size / point. `device` names the ranks'
    device type ("cuda" or "cpu"). On "cuda" the current card must be the
    one initialize_multihost bound the rank to: RuntimeError otherwise
    (something set another card after it)."""
    if not dist.is_initialized():
        raise RuntimeError("make_mesh needs a process group: call initialize_multihost first")
    card = bound_card()
    if (torch.device(device).type == "cuda" and card is not None
            and torch.cuda.current_device() != card.index):
        raise RuntimeError(f"make_mesh: this rank is bound to {card}, but the current card is "
                           f"cuda:{torch.cuda.current_device()}")
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


def point_shard(x: torch.Tensor, mesh: DeviceMesh, dim: int = 1) -> torch.Tensor:
    """This rank's share of `x` along `dim`, split evenly over the point
    group (shard_rows): a slice, whose backward is autograd's own (the
    cotangent in this rank's rows, zeros elsewhere)."""
    return shard_rows(x, mesh, POINT_AXIS, dim)


class _GatherPoints(torch.autograd.Function):
    """all_gather over the point group, joined on `dim` in axis order. A
    bf16 tensor is gathered as it is, bit for bit (gloo takes bf16
    collectives on CPU and CUDA tensors).

    Backward, for a step in which each rank of the group backpropagates
    1 / P of the same loss: a rank's cotangent of the gathered tensor is its
    share of the whole one, so the shares are summed over the group
    (all_reduce, in at least f32: a bf16 cotangent is rounded once, after
    the sum), then the rank keeps the rows it contributed."""

    @staticmethod
    def forward(ctx, x, mesh, dim):
        ctx.mesh, ctx.dim = mesh, dim
        return all_gather_cat(x, mesh, POINT_AXIS, dim)

    @staticmethod
    def backward(ctx, g):
        total = g.to(torch.promote_types(g.dtype, torch.float32),
                     memory_format=torch.contiguous_format, copy=True)
        dist.all_reduce(total, group=axis_group(ctx.mesh, POINT_AXIS))
        return point_shard(total.to(g.dtype), ctx.mesh, ctx.dim), None, None


def gather_points(x: torch.Tensor, mesh: DeviceMesh, dim: int = 1) -> torch.Tensor:
    """The point group's shards of `x` (equal shapes) joined on `dim`:
    the inverse of point_shard, differentiable (see _GatherPoints: the
    backward sums the ranks' cotangents, then takes this rank's rows)."""
    if axis_size(mesh, POINT_AXIS) == 1:
        return x
    return _GatherPoints.apply(x, mesh, dim)


def axis_rows(mesh: DeviceMesh, axis: str, n: int) -> Tuple[int, int]:
    """This rank's rows [lo, hi) of n, split evenly over `axis`:
    [i n / size, (i + 1) n / size), i this rank's index along it."""
    size = axis_size(mesh, axis)
    assert n % size == 0, (n, axis, size)
    lo = axis_index(mesh, axis) * (n // size)
    return lo, lo + n // size


def shard_rows(x, mesh: DeviceMesh, axis: str = DATA_AXIS, dim: int = 0):
    """This rank's rows (along `dim`) of `x`, split evenly over `axis`
    (axis_rows)."""
    lo, hi = axis_rows(mesh, axis, x.shape[dim])
    return x.narrow(dim, lo, hi - lo)


def batch_pair_sharding(mesh: DeviceMesh) -> Tuple[Tuple, ...]:
    """The DTensor placements of a (src, tgt, R, t) batch over the mesh's
    (data, point) dims: pairs split over "data", replicated over "point"
    (the JAX package places the clouds' points split over "point"; the
    port's point group holds whole clouds and splits the work within the
    step, see the module docstring)."""
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
    moved to the device. The device is the rank's (rank_card)."""
    dev = rank_card(mesh.device_type)
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
