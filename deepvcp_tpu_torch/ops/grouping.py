"""Batched point gathers (port of deepvcp_tpu/ops/grouping.py::index_points)."""

from __future__ import annotations

import torch


def index_points(points: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """points [B, N, C], idx [B, ...] integer indices into N ->
    [B, *idx.shape[1:], C]."""
    B, _, C = points.shape
    flat = idx.reshape(B, -1, 1).expand(-1, -1, C)
    return torch.gather(points, 1, flat).reshape(*idx.shape, C)
