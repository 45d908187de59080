"""Multi-rank neighbour search: ring KNN (port of
deepvcp_tpu/ops/distributed.py).

The point-cloud analogue of ring attention: both the query and the
reference points are split over the mesh's "point" group. At each step
every rank computes the exact KNN of its query shard against the reference
block it holds, merges it into a running top-k, and passes the block on to
the next rank of the ring (`dist.batch_isend_irecv`). After P steps every
query has seen every reference point; a rank holds one [M/P, N/P] distance
tile and one block at a time.

The JAX package runs this in `shard_map` with `lax.top_k`, outside any
Pallas kernel; the port selects each block's top-k with ops/knn.py::select
(on the card, kernel K6's f32 arm for k <= 32) and merges in plain
PyTorch on each rank's device.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.distributed as dist

from deepvcp_tpu_torch.ops.knn import select
from deepvcp_tpu_torch.parallel.mesh import (
    POINT_AXIS, all_gather_cat, axis_group, axis_index, axis_peers, axis_size, shard_rows)


def ring_knn(mesh, ref: torch.Tensor, query: torch.Tensor, k: int,
             batch_axis: Optional[str] = None,
             gather: bool = True) -> Tuple[torch.Tensor, torch.Tensor]:
    """Exact K nearest neighbours with both clouds split over the mesh's
    "point" group, in the JAX function's global view: every rank of a point
    group passes the same ref [B, N, 3] and query [B, M, 3] (N and M
    divisible by the group's size P, k <= N / P) and receives the whole
    result, (dist [B, M, k] ascending euclidean distances, idx [B, M, k]
    int64 global indices into N), as the port's `knn` computes it but for
    the order of distance ties.

    `batch_axis` (e.g. "data"): a mesh dim that the batch rows are split
    over here, as in JAX: each rank along it computes its B / size rows
    (B divisible by that size) and the rows are all-gathered over it, so
    the result is that of the replicated form.

    With `gather=False`, `query` is this rank's query shard [B, M / P, 3]
    (rows [r M / P, (r + 1) M / P) of the global query, r its point index)
    and the result is that shard's, with no final all-gather: the form of
    the point-partitioned forward, whose rank owns those queries."""
    P = axis_size(mesh, POINT_AXIS)
    B, N, _ = ref.shape
    M = query.shape[1] * (1 if gather else P)
    shard_n, shard_m = N // P, M // P
    assert shard_n * P == N, (N, P)
    assert shard_m * P == M, (M, P)
    assert k <= shard_n, (k, shard_n)
    assert gather or batch_axis is None, "a query shard takes no batch axis"
    if batch_axis is not None:
        assert B % axis_size(mesh, batch_axis) == 0, (ref.shape, batch_axis, mesh.shape)
        ref, query = shard_rows(ref, mesh, batch_axis), shard_rows(query, mesh, batch_axis)
    me = axis_index(mesh, POINT_AXIS)
    peers = axis_peers(mesh, POINT_AXIS)
    group = axis_group(mesh, POINT_AXIS)
    q = query[:, me * shard_m:(me + 1) * shard_m] if gather else query
    block = ref[:, me * shard_n:(me + 1) * shard_n].contiguous()
    best_d = best_i = None
    for step in range(P):
        # the block held at this step came `step` hops round the ring
        owner = (me - step) % P
        d2, local = select(block, q, k)
        gidx = owner * shard_n + local
        if best_d is None:
            best_d, best_i = d2, gidx
        else:
            # merge with the running top-k, the running best first
            best_d, sel = torch.topk(torch.cat([best_d, d2], dim=-1), k, dim=-1,
                                     largest=False)
            best_i = torch.gather(torch.cat([best_i, gidx], dim=-1), -1, sel)
        if step + 1 < P:
            # pass the block on to the next rank; the last step's block is
            # not needed, so a ring of one exchanges nothing
            incoming = torch.empty_like(block)
            ops = [dist.P2POp(dist.isend, block, peers[(me + 1) % P], group),
                   dist.P2POp(dist.irecv, incoming, peers[(me - 1) % P], group)]
            for req in dist.batch_isend_irecv(ops):
                req.wait()
            block = incoming
    dist_out = torch.sqrt(torch.clamp_min(best_d, 0.0))
    if not gather:
        return dist_out, best_i
    dist_out = all_gather_cat(dist_out, mesh, POINT_AXIS, dim=1)
    idx = all_gather_cat(best_i, mesh, POINT_AXIS, dim=1)
    if batch_axis is not None:
        dist_out = all_gather_cat(dist_out, mesh, batch_axis, dim=0)
        idx = all_gather_cat(idx, mesh, batch_axis, dim=0)
    return dist_out, idx
