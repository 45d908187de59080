"""Point gathers and ball-query grouping (port of deepvcp_tpu/ops/grouping.py).

The dense ball query keeps the `nsample` LOWEST ORIGINAL indices in radius
(the reference's semantics); the windowed engine's first-in-sorted-order
query lives in ops/neighbors.py.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepvcp_tpu_torch.ops.distance import map_query_chunks, square_distance
from deepvcp_tpu_torch.ops.sampling import farthest_point_sample


def pc_normalize(pc: torch.Tensor) -> torch.Tensor:
    """Centre a cloud [..., N, 3] and scale it into the unit sphere."""
    pc = pc - torch.mean(pc, dim=-2, keepdim=True)
    m = torch.amax(torch.linalg.norm(pc, dim=-1), dim=-1)
    return pc / (m[..., None, None] + 1e-12)


def group_all(xyz: torch.Tensor, features: Optional[torch.Tensor] = None
              ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One group of all points centred at the origin: (new_xyz [B, 1, 3]
    zeros, grouped [B, 1, N, 3+D])."""
    B, _, C = xyz.shape
    grouped = xyz[:, None]
    if features is not None:
        grouped = torch.cat([grouped, features[:, None]], dim=-1)
    return xyz.new_zeros(B, 1, C), grouped


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] integer indices into N ->
    [B, *idx.shape[1:], C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)


def query_ball_point(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                     chunk: Optional[int] = None, return_count: bool = False):
    """Up to `nsample` points of xyz [B, N, 3] within `radius` of each query
    new_xyz [B, S, 3]: the nsample lowest in-radius indices, ascending,
    padded with the first hit. Returns idx [B, S, nsample] int64 (a zero-hit
    row is clamped to N - 1) and, with return_count, count [B, S] =
    min(hits, nsample), 0 marking rows whose gathers are garbage.

    Distances come from square_distance's matmul expansion, as in JAX, so a
    pair within f32 rounding of the radius may fall on either side in
    another package or on another device. The selection itself is exact:
    torch.topk of the candidates' index values (in-radius index or N), whose
    in-radius values are distinct, so its result does not depend on a tie
    rule."""
    N = xyz.shape[-2]

    def run(queries):
        in_range = square_distance(queries, xyz) <= radius * radius
        cand = torch.where(in_range, torch.arange(N, device=xyz.device), N)
        group_idx = torch.topk(cand, nsample, dim=-1, largest=False, sorted=True).values
        count = torch.sum(group_idx != N, dim=-1)
        group_idx = torch.where(group_idx == N, group_idx[..., :1], group_idx)
        return torch.clamp_max(group_idx, N - 1), count

    idx, count = run(new_xyz) if chunk is None else map_query_chunks(run, new_xyz, chunk)
    return (idx, count) if return_count else idx


def group_neighbors(radius: float, nsample: int, xyz: torch.Tensor, new_xyz: torch.Tensor,
                    features: Optional[torch.Tensor] = None, chunk: Optional[int] = None,
                    return_count: bool = False):
    """Ball query, gather and recentre: (grouped [B, S, nsample, 3+D] with
    the local xyz first, grouped_xyz_local [B, S, nsample, 3], idx [B, S,
    nsample]) and, with return_count, count [B, S]. Rows of zero-hit
    queries are zeroed."""
    idx, count = query_ball_point(radius, nsample, xyz, new_xyz, chunk=chunk,
                                  return_count=True)
    ok = (count > 0)[..., None, None]
    local = torch.where(ok, index_points(xyz, idx) - new_xyz[..., :, None, :], 0.0)
    grouped = local
    if features is not None:
        grouped = torch.cat([local, torch.where(ok, index_points(features, idx), 0.0)], dim=-1)
    if return_count:
        return grouped, local, idx, count
    return grouped, local, idx


def sample_and_group(npoint: int, radius: float, nsample: int, xyz: torch.Tensor,
                     features: Optional[torch.Tensor] = None, chunk: Optional[int] = None
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """FPS of npoint centroids (kernel K3 on the card; skipped when npoint
    == N), then group_neighbors: (new_xyz [B, npoint, 3], grouped [B,
    npoint, nsample, 3+D], idx [B, npoint, nsample])."""
    new_xyz = xyz if npoint == xyz.shape[1] else index_points(
        xyz, farthest_point_sample(xyz, npoint))
    grouped, _, idx = group_neighbors(radius, nsample, xyz, new_xyz, features, chunk=chunk)
    return new_xyz, grouped, idx
