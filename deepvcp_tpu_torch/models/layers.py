"""Neural modules of the port (port of deepvcp_tpu/models/layers.py).

Channels-last [B, ..., C] at every public function, as in the JAX package.
Submodule names follow the flax parameter tree (Dense_0, Conv_0, sa1, ...)
so that convert.flax_to_torch is a renaming.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
from torch import nn

from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.models.fused_sa import BandedSetAbstraction
from deepvcp_tpu_torch.ops.grouping import index_points
from deepvcp_tpu_torch.ops.neighbors import sort_cloud


class FeatureExtraction(nn.Module):
    """FE stack, banded engine: sort the cloud along x once, run the SA stages
    in sorted order, project to feat_dim, and unpermute to input order."""

    def __init__(self, cfg: DeepVCPConfig):
        super().__init__()
        cfg = cfg.resolve()
        if cfg.neighbor_method != "banded":
            raise NotImplementedError(
                f"neighbor_method={cfg.neighbor_method!r}: only the banded "
                f"engine is ported (windowed/dense: ROADMAP M10)")
        in_features = 3 if cfg.use_normal else None
        for i, layer in enumerate(cfg.sa_layers):
            self.add_module(f"sa{i + 1}", BandedSetAbstraction(
                layer, in_features, use_batchnorm=cfg.use_batchnorm))
            in_features = layer.mlp[-1]
        self.n_sa = len(cfg.sa_layers)
        self.proj = nn.Linear(in_features, cfg.feat_dim)

    def forward(self, xyz: torch.Tensor, normals: Optional[torch.Tensor]) -> torch.Tensor:
        """xyz [B, N, 3], normals [B, N, 3] or None -> features [B, N, feat_dim]."""
        cloud = sort_cloud(xyz)
        feats = None if normals is None else index_points(normals, cloud.perm)
        for i in range(1, self.n_sa + 1):
            feats = getattr(self, f"sa{i}")(cloud.xyz, feats)
        feats = self.proj(feats)
        B, N = cloud.perm.shape
        inv_perm = torch.empty_like(cloud.perm).scatter_(
            1, cloud.perm, torch.arange(N, device=xyz.device).expand(B, N))
        return index_points(feats, inv_perm)


def _dense_stack(widths: Tuple[int, ...], in_features: int) -> list:
    return [nn.Linear(i, o) for i, o in zip((in_features,) + tuple(widths[:-1]), widths)]


class WeightingLayer(nn.Module):
    """Per-point saliency MLP, ReLU / ReLU / softplus -> [B, N] >= 0."""

    def __init__(self, mlp: Tuple[int, ...], in_features: int):
        super().__init__()
        for i, layer in enumerate(_dense_stack(mlp, in_features)):
            self.add_module(f"Dense_{i}", layer)
        self.n = len(mlp)

    def forward(self, features: torch.Tensor) -> torch.Tensor:
        x = features
        for i in range(self.n - 1):
            x = torch.relu(getattr(self, f"Dense_{i}")(x))
        return nn.functional.softplus(getattr(self, f"Dense_{self.n - 1}")(x))[..., 0]


class FeatEmbedding(nn.Module):
    """Siamese DFE MLP (ReLU between hidden layers when `activation`) and a
    max over axis -2, for both [B,K,ns,35] and [B,K,C,ns,35] inputs."""

    def __init__(self, mlp: Tuple[int, ...], in_features: int, activation: bool = True):
        super().__init__()
        for i, layer in enumerate(_dense_stack(mlp, in_features)):
            self.add_module(f"Dense_{i}", layer)
        self.n = len(mlp)
        self.activation = activation

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n):
            x = getattr(self, f"Dense_{i}")(x)
            if self.activation and i + 1 < self.n:
                x = torch.relu(x)
        return torch.amax(x, dim=-2)


class CPG(nn.Module):
    """Corresponding-point generation: squared-difference cost volume on the
    voxel grid -> 3 x Conv3d (no nonlinearity) -> softmax over candidates ->
    weighted-centroid VCP. flax's Conv(padding="SAME") with a 3^3 kernel is
    Conv3d(padding=1); the channels-last volume is permuted to NCDHW."""

    def __init__(self, channels: Tuple[int, ...], grid_size: int, in_features: int):
        super().__init__()
        self.grid_size = grid_size
        prev = in_features
        for i, ch in enumerate(channels):
            self.add_module(f"Conv_{i}", nn.Conv3d(prev, ch, kernel_size=3, padding=1))
            prev = ch
        self.n = len(channels)

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
            x = getattr(self, f"Conv_{i}")(x)
        weights = torch.softmax(x.reshape(B, K, C), dim=-1)
        vcp = torch.einsum("bkc,bkcd->bkd", weights, candidates)
        return vcp, weights
