"""Multi-scale grouping and feature propagation (port of
deepvcp_tpu/models/extra_layers.py): PointNet++'s `SetAbstractionMsg` and
`FeaturePropagation`, which the reference ships but never wires into
DeepVCP. Parameter names follow the flax modules (b{i}_dense{j}, b{i}_bn{j};
dense{j}, bn{j}), so convert.flax_to_torch loads their variables.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
from torch import nn

from deepvcp_tpu_torch.models.fused_sa import BN_EPS, batch_norm, linear
from deepvcp_tpu_torch.ops import farthest_point_sample, group_neighbors, index_points
from deepvcp_tpu_torch.ops import square_distance


def _mlp(module: nn.Module, prefix: str, widths: Sequence[int], in_features: int,
         use_batchnorm: bool) -> None:
    prev = in_features
    for j, c in enumerate(widths):
        module.add_module(f"{prefix}dense{j}", nn.Linear(prev, c))
        if use_batchnorm:
            module.add_module(f"{prefix}bn{j}", nn.BatchNorm1d(c, eps=BN_EPS))
        prev = c


class SetAbstractionMSG(nn.Module):
    """One FPS sampling (kernel K3 on the card; skipped when npoint == N),
    then one (radius, nsample, mlp) branch per scale: group, Dense -> BN ->
    ReLU per neighbour, max over neighbours; the branches concatenated."""

    def __init__(self, npoint: int, radius_list: Sequence[float], nsample_list: Sequence[int],
                 mlp_list: Sequence[Sequence[int]], in_features: int = 0,
                 use_batchnorm: bool = True, dtype: torch.dtype = torch.float32):
        super().__init__()
        self.npoint = npoint
        self.branches = tuple(zip(radius_list, nsample_list, (tuple(m) for m in mlp_list)))
        self.use_batchnorm, self.dtype = use_batchnorm, dtype
        for i, (_, _, mlp) in enumerate(self.branches):
            _mlp(self, f"b{i}_", mlp, 3 + in_features, use_batchnorm)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor]
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz [B, N, 3], features [B, N, D] or None -> (new_xyz [B, npoint,
        3], features [B, npoint, sum of the branches' last widths])."""
        new_xyz = xyz if self.npoint == xyz.shape[1] else index_points(
            xyz, farthest_point_sample(xyz, self.npoint))
        outs = []
        for i, (radius, nsample, mlp) in enumerate(self.branches):
            h, _, _ = group_neighbors(radius, nsample, xyz, new_xyz, features)
            for j in range(len(mlp)):
                h = linear(getattr(self, f"b{i}_dense{j}"), h, self.dtype)
                if self.use_batchnorm:
                    h = batch_norm(getattr(self, f"b{i}_bn{j}"), h, self.training, self.dtype)
                h = torch.relu(h)
            outs.append(torch.amax(h, dim=2))
        return new_xyz, torch.cat(outs, dim=-1)


class FeaturePropagation(nn.Module):
    """Inverse-distance-weighted interpolation of sparse features onto a
    dense point set from each dense point's 3 nearest sparse points (all of
    one point's copies when S == 1), optionally concatenated after the dense
    points' own features, then Dense -> BN -> ReLU per point."""

    def __init__(self, mlp: Sequence[int], in_features: int, use_batchnorm: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.n = len(mlp)
        self.use_batchnorm, self.dtype = use_batchnorm, dtype
        _mlp(self, "", mlp, in_features, use_batchnorm)

    def forward(self, xyz_dense: torch.Tensor, xyz_sparse: torch.Tensor,
                feat_dense: Optional[torch.Tensor], feat_sparse: torch.Tensor) -> torch.Tensor:
        """xyz_dense [B, N, 3], xyz_sparse [B, S, 3], feat_dense [B, N, D1] or
        None, feat_sparse [B, S, D2] -> [B, N, mlp[-1]]."""
        if xyz_sparse.shape[1] == 1:
            interpolated = feat_sparse.expand(-1, xyz_dense.shape[1], -1)
        else:
            # the 3 nearest, ties to the lower index (lax.top_k's rule)
            d, idx = torch.sort(square_distance(xyz_dense, xyz_sparse), dim=-1, stable=True)
            d, idx = d[..., :3], idx[..., :3]
            w = 1.0 / (torch.clamp_min(d, 0.0) + 1e-8)
            w = w / torch.sum(w, dim=-1, keepdim=True)
            interpolated = torch.einsum("bnk,bnkd->bnd", w, index_points(feat_sparse, idx))
        h = interpolated if feat_dense is None else torch.cat([feat_dense, interpolated], dim=-1)
        for j in range(self.n):
            h = linear(getattr(self, f"dense{j}"), h, self.dtype)
            if self.use_batchnorm:
                h = batch_norm(getattr(self, f"bn{j}"), h, self.training, self.dtype)
            h = torch.relu(h)
        return h
