"""Gather-free banded set abstraction (port of deepvcp_tpu/models/fused_sa.py
::BandedSetAbstraction and banded_max_pool).

The first projection of the reference SA stage, Dense(concat(x_n - x_q, f_n)),
is a difference of per-point projections, u_n - p_q + b0, so the pooled
first layer is (masked max of u over the in-radius slab) - p_q + b0: the
pair tensor is never built. The max is kernel K1 and its backward kernel K2
(ops/kernels/band_max.py), over the exact in-radius set. The rest of the MLP
runs per point.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from deepvcp_tpu_torch.config import SALayerConfig
from deepvcp_tpu_torch.ops.kernels.band_max import banded_masked_max, banded_masked_max_grad

BN_EPS = 1e-5        # flax.linen.BatchNorm's defaults
BN_MOMENTUM = 0.99   # flax's: running = 0.99 * running + 0.01 * batch


class _BandedMaxPool(torch.autograd.Function):
    """K1 forward, K2 backward: the custom VJP of the JAX banded_max_pool."""

    @staticmethod
    def forward(ctx, sorted_xyz, u, radius):
        out = banded_masked_max(sorted_xyz, u, radius)
        ctx.save_for_backward(sorted_xyz, u, out)
        ctx.radius = radius
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sorted_xyz, u, out = ctx.saved_tensors
        grad_u = None
        if ctx.needs_input_grad[1]:
            grad_u = banded_masked_max_grad(sorted_xyz, u, out, g.contiguous(), ctx.radius)
        # the pooled max depends on xyz only through the piecewise-constant
        # radius mask: its gradient is zero almost everywhere (JAX returns
        # zeros; None is the same to autograd)
        return None, grad_u, None


def banded_max_pool(sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float) -> torch.Tensor:
    """Differentiable exact in-radius masked max: [B, N, 3], [B, N, C] ->
    [B, N, C]. Ties at a query's max each receive its full cotangent."""
    return _BandedMaxPool.apply(sorted_xyz.contiguous(), u.contiguous(), float(radius))


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, training: bool) -> torch.Tensor:
    """flax.linen.BatchNorm over the last axis.

    Eval: the running statistics. Training: the batch mean and the biased
    batch variance over every other axis (flax's E[x^2] - E[x]^2, clipped
    at 0), and the running statistics move as running = 0.99 * running +
    0.01 * batch, biased variance included. F.batch_norm(training=True) would
    fold the unbiased variance into running_var, so the update is written
    out here."""
    if not training:
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=False, eps=BN_EPS)
        return y.reshape(shape)
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes)
    var = torch.clamp_min((x * x).mean(dim=axes) - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    return (x - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias


class BandedSetAbstraction(nn.Module):
    """One banded SA stage on a sorted cloud: pooled first projection, then
    BN and the per-point (Dense -> BN -> ReLU) tail. Parameter names follow
    the flax module (proj_xyz, proj_feat, bias0, bn{i}, dense{i}). BN runs
    on batch statistics and updates its running ones in `train()` mode."""

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
        if not self.use_batchnorm:
            return x
        return batch_norm(getattr(self, f"bn{i}"), x, self.training)

    def forward(self, sorted_xyz: torch.Tensor,
                features: Optional[torch.Tensor]) -> torch.Tensor:
        """sorted_xyz [B, N, 3], features [B, N, D] or None -> [B, N, mlp[-1]]
        (sorted order)."""
        p = self.proj_xyz(sorted_xyz)
        u = p if features is None else p + self.proj_feat(features)
        max_u = banded_max_pool(sorted_xyz, u, self.radius)
        # relu(max) == max(relu); relu also clamps an empty row's -1e30
        h = torch.relu(max_u - p + self.bias0)
        h = self._norm(h, 0)
        for i in range(1, self.n_dense + 1):
            h = torch.relu(self._norm(getattr(self, f"dense{i}")(h), i))
        return h
