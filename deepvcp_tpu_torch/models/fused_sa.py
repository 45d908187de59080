"""Gather-free banded set abstraction (port of deepvcp_tpu/models/fused_sa.py
::BandedSetAbstraction).

The first projection of the reference SA stage, Dense(concat(x_n - x_q, f_n)),
is a difference of per-point projections, u_n - p_q + b0, so the pooled
first layer is (masked max of u over the in-radius slab) - p_q + b0: the
pair tensor is never built. The max is kernel K1 (ops/kernels/band_max.py),
over the exact in-radius set. The rest of the MLP runs per point.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from deepvcp_tpu.config import SALayerConfig
from deepvcp_tpu_torch.ops.kernels.band_max import banded_masked_max

BN_EPS = 1e-5  # flax.linen.BatchNorm's default


def batch_norm_eval(bn: nn.BatchNorm1d, x: torch.Tensor) -> torch.Tensor:
    """Inference BatchNorm over the last axis with the running statistics
    (the port is inference-only: training, with batch statistics, is
    ROADMAP M7)."""
    shape = x.shape
    y = F.batch_norm(x.reshape(-1, shape[-1]), bn.running_mean, bn.running_var,
                     bn.weight, bn.bias, training=False, eps=BN_EPS)
    return y.reshape(shape)


class BandedSetAbstraction(nn.Module):
    """One banded SA stage on a sorted cloud: pooled first projection, then
    BN and the per-point (Dense -> BN -> ReLU) tail. Parameter names follow
    the flax module (proj_xyz, proj_feat, bias0, bn{i}, dense{i})."""

    def __init__(self, layer: SALayerConfig, in_features: Optional[int],
                 use_batchnorm: bool = True):
        super().__init__()
        self.radius = float(layer.radius)
        self.use_batchnorm = use_batchnorm
        c0 = layer.mlp[0]
        self.proj_xyz = nn.Linear(3, c0, bias=False)
        self.proj_feat = nn.Linear(in_features, c0, bias=False) if in_features else None
        self.bias0 = nn.Parameter(torch.zeros(c0))
        self.n_dense = len(layer.mlp) - 1
        for i, c in enumerate(layer.mlp):
            if i > 0:
                self.add_module(f"dense{i}", nn.Linear(layer.mlp[i - 1], c))
            if use_batchnorm:
                self.add_module(f"bn{i}", nn.BatchNorm1d(c, eps=BN_EPS))

    def _norm(self, x: torch.Tensor, i: int) -> torch.Tensor:
        return batch_norm_eval(getattr(self, f"bn{i}"), x) if self.use_batchnorm else x

    def forward(self, sorted_xyz: torch.Tensor,
                features: Optional[torch.Tensor]) -> torch.Tensor:
        """sorted_xyz [B, N, 3], features [B, N, D] or None -> [B, N, mlp[-1]]
        (sorted order)."""
        p = self.proj_xyz(sorted_xyz)
        u = p if features is None else p + self.proj_feat(features)
        max_u = banded_masked_max(sorted_xyz.contiguous(), u.contiguous(), self.radius)
        # relu(max) == max(relu); relu also clamps an empty row's -1e30
        h = torch.relu(max_u - p + self.bias0)
        h = self._norm(h, 0)
        for i in range(1, self.n_dense + 1):
            h = torch.relu(self._norm(getattr(self, f"dense{i}")(h), i))
        return h
