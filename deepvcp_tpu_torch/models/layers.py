"""Neural modules of the port (port of deepvcp_tpu/models/layers.py).

Channels-last [B, ..., C] at every public function, as in the JAX package.
Submodule names follow the flax parameter tree (Dense_0, Conv_0, sa1, ...)
so that convert.flax_to_torch is a renaming.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from deepvcp_tpu_torch.config import DeepVCPConfig, SALayerConfig
from deepvcp_tpu_torch.models.fused_sa import (
    BN_EPS, BandedSetAbstraction, batch_norm, linear)
from deepvcp_tpu_torch.ops.grouping import group_neighbors, index_points
from deepvcp_tpu_torch.ops.neighbors import (
    SortedCloud, sort_cloud, window_for, windowed_ball_query)
from deepvcp_tpu_torch.ops.sampling import farthest_point_sample


def compute_dtype(cfg: DeepVCPConfig) -> torch.dtype:
    """The torch dtype of cfg.compute_dtype ("float32" or "bfloat16")."""
    return getattr(torch, cfg.compute_dtype)


class SetAbstraction(nn.Module):
    """PointNet++ set abstraction on gathers (the windowed and dense
    engines): FPS when npoint != N (kernel K3 on the card), ball-query
    grouping, the shared MLP per neighbour, then a max over neighbours.
    The first layer is split as in flax, Dense(concat(local_xyz, f)) =
    proj_xyz(local_xyz) (with bias) + proj_feat(f)[idx] (without), and rows
    of zero-hit queries are zeroed before the first BatchNorm.

    With a `window` and a sorted cloud (npoint == N) the neighbours are the
    first nsample in-radius points of the sorted window; otherwise the
    nsample lowest indices in radius over the whole cloud (dense)."""

    def __init__(self, layer: SALayerConfig, in_features: Optional[int],
                 use_batchnorm: bool = True, query_chunk: Optional[int] = None,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = layer
        self.use_batchnorm = use_batchnorm
        self.query_chunk, self.dtype = query_chunk, dtype
        c0 = layer.mlp[0]
        self.proj_xyz = nn.Linear(3, c0)
        self.proj_feat = nn.Linear(in_features, c0, bias=False) if in_features else None
        self.n_dense = len(layer.mlp) - 1
        for i, c in enumerate(layer.mlp):
            if i > 0:
                self.add_module(f"dense{i}", nn.Linear(layer.mlp[i - 1], c))
            if use_batchnorm:
                self.add_module(f"bn{i}", nn.BatchNorm1d(c, eps=BN_EPS))

    def _norm_act(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if self.use_batchnorm:
            x = batch_norm(getattr(self, f"bn{i}"), x, self.training, self.dtype)
        return torch.relu(x)

    def forward(self, xyz: torch.Tensor, features: Optional[torch.Tensor],
                sorted_cloud: Optional[SortedCloud] = None, window: Optional[int] = None
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """xyz [B, N, 3], features [B, N, D] or None -> (new_xyz [B, S, 3],
        features [B, S, mlp[-1]]). With a sorted cloud, xyz and features are
        in its order and so are the outputs; `window` is window_for(N, ...)
        of this call's N."""
        cfg, dt = self.layer, self.dtype
        N = xyz.shape[1]
        new_xyz = xyz if cfg.npoint == N else index_points(
            xyz, farthest_point_sample(xyz, cfg.npoint))
        if sorted_cloud is not None and window is not None and cfg.npoint == N:
            idx, count = windowed_ball_query(sorted_cloud, new_xyz, cfg.radius, cfg.nsample,
                                             window, return_count=True)
            local_xyz = index_points(xyz, idx) - new_xyz[..., :, None, :]
        else:
            _, local_xyz, idx, count = group_neighbors(
                cfg.radius, cfg.nsample, xyz, new_xyz, chunk=self.query_chunk,
                return_count=True)
        h = linear(self.proj_xyz, local_xyz, dt)                      # [B, S, ns, c0]
        if features is not None:
            h = h + index_points(linear(self.proj_feat, features, dt), idx)
        h = torch.where((count > 0)[..., None, None], h, 0.0)
        h = self._norm_act(h, 0)
        for i in range(1, self.n_dense + 1):
            h = self._norm_act(linear(getattr(self, f"dense{i}"), h, dt), i)
        return new_xyz, torch.amax(h, dim=2)


class FeatureExtraction(nn.Module):
    """FE stack: the SA stages chained, then a projection to feat_dim.

    banded (the default): sort the cloud along x once, run the banded
    stages in sorted order (exact slab through K1/K2, or the static band),
    unpermute. windowed: the same sort, gather-path stages. Both size a
    stage's window on each call from the stage's own N, as
    window_for(N, r, spatial_extent, window_safety). dense: gather-path
    stages on the unsorted cloud, grouped over query_chunk queries at a
    time."""

    def __init__(self, cfg: DeepVCPConfig):
        super().__init__()
        cfg = cfg.resolve()
        self.method = cfg.neighbor_method
        self.spatial_extent, self.window_safety = cfg.spatial_extent, cfg.window_safety
        dt = compute_dtype(cfg)
        self.dtype = dt
        in_features = 3 if cfg.use_normal else None
        for i, layer in enumerate(cfg.sa_layers):
            if self.method == "banded":
                sa = BandedSetAbstraction(
                    layer, in_features, use_batchnorm=cfg.use_batchnorm,
                    use_kernel=cfg.use_pallas_band_max, tile=cfg.band_tile, dtype=dt)
            else:
                sa = SetAbstraction(layer, in_features, use_batchnorm=cfg.use_batchnorm,
                                    query_chunk=cfg.query_chunk, dtype=dt)
            self.add_module(f"sa{i + 1}", sa)
            in_features = layer.mlp[-1]
        self.n_sa = len(cfg.sa_layers)
        self.proj = nn.Linear(in_features, cfg.feat_dim)

    def forward(self, xyz: torch.Tensor, normals: Optional[torch.Tensor]) -> torch.Tensor:
        """xyz [B, N, 3], normals [B, N, 3] or None -> features [B, N, feat_dim]."""
        if self.method == "dense":
            feats = normals
            for i in range(1, self.n_sa + 1):
                xyz, feats = getattr(self, f"sa{i}")(xyz, feats)
            return linear(self.proj, feats, self.dtype)
        cloud = sort_cloud(xyz)
        feats = None if normals is None else index_points(normals, cloud.perm)
        x = cloud.xyz
        for i in range(1, self.n_sa + 1):
            sa = getattr(self, f"sa{i}")
            window = window_for(x.shape[1], sa.layer.radius, self.spatial_extent,
                                self.window_safety)
            if self.method == "banded":
                feats = sa(x, feats, window)
            else:
                x, feats = sa(x, feats, sorted_cloud=cloud, window=window)
        feats = linear(self.proj, feats, self.dtype)
        B, N = cloud.perm.shape
        inv_perm = torch.empty_like(cloud.perm).scatter_(
            1, cloud.perm, torch.arange(N, device=xyz.device).expand(B, N))
        return index_points(feats, inv_perm)


def _dense_stack(widths: Tuple[int, ...], in_features: int) -> list:
    return [nn.Linear(i, o) for i, o in zip((in_features,) + tuple(widths[:-1]), widths)]


class WeightingLayer(nn.Module):
    """Per-point saliency MLP, ReLU / ReLU / softplus -> [B, N] >= 0, in
    `dtype` (bf16 saliencies under compute_dtype="bfloat16", as flax's)."""

    def __init__(self, mlp: Tuple[int, ...], in_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, layer in enumerate(_dense_stack(mlp, in_features)):
            self.add_module(f"Dense_{i}", layer)
        self.n = len(mlp)
        self.dtype = dtype

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features
        for i in range(self.n - 1):
            x = torch.relu(linear(getattr(self, f"Dense_{i}"), x, self.dtype))
        x = linear(getattr(self, f"Dense_{self.n - 1}"), x, self.dtype)
        return nn.functional.softplus(x)[..., 0]


class FeatEmbedding(nn.Module):
    """Siamese DFE MLP (ReLU between hidden layers when `activation`) and a
    max over axis -2, for both [B,K,ns,35] and [B,K,C,ns,35] inputs."""

    def __init__(self, mlp: Tuple[int, ...], in_features: int, activation: bool = True,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        for i, layer in enumerate(_dense_stack(mlp, in_features)):
            self.add_module(f"Dense_{i}", layer)
        self.n = len(mlp)
        self.activation = activation
        self.dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = linear(getattr(self, f"Dense_{i}"), x, self.dtype)
            if self.activation and i + 1 < self.n:
                x = torch.relu(x)
        return torch.amax(x, dim=-2)


class CPG(nn.Module):
    """Corresponding-point generation: squared-difference cost volume on the
    voxel grid -> 3 x Conv3d (no nonlinearity) -> softmax over candidates ->
    weighted-centroid VCP. flax's Conv(padding="SAME") with a 3^3 kernel is
    Conv3d(padding=1); the channels-last volume is permuted to NCDHW. In
    bf16 the convolutions and the softmax run in bf16 and the centroid in
    f32 (bf16 weights meet f32 candidates), as in flax."""

    def __init__(self, channels: Tuple[int, ...], grid_size: int, in_features: int,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.grid_size = grid_size
        prev = in_features
        for i, ch in enumerate(channels):
            self.add_module(f"Conv_{i}", nn.Conv3d(prev, ch, kernel_size=3, padding=1))
            prev = ch
        self.n = len(channels)
        self.dtype = dtype

    def _conv(self, i: int, x: torch.Tensor) -> torch.Tensor:
        conv = getattr(self, f"Conv_{i}")
        if self.dtype == torch.float32:
            return conv(x)
        y = nn.functional.conv3d(x.to(self.dtype), conv.weight.to(self.dtype), padding=1)
        return y + conv.bias.to(self.dtype)[:, None, None, None]

    def forward(self, src_desc: torch.Tensor, tgt_desc: torch.Tensor,
                candidates: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """src_desc [B,K,F], tgt_desc [B,K,C,F], candidates [B,K,C,3] ->
        (vcp [B,K,3], weights [B,K,C])."""
        B, K, C, F = tgt_desc.shape
        gs = self.grid_size
        if C != gs ** 3:
            raise ValueError(f"candidates {C} != grid {gs}^3")
        cost = torch.square(src_desc[:, :, None, :] - tgt_desc)
        x = cost.reshape(B * K, gs, gs, gs, F).permute(0, 4, 1, 2, 3)
        for i in range(self.n):
            x = self._conv(i, x)
        weights = torch.softmax(x.reshape(B, K, C), dim=-1)
        vcp = torch.einsum("bkc,bkcd->bkd", weights.to(candidates.dtype), candidates)
        return vcp, weights
