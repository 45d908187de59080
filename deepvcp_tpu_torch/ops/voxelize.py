"""Voxel-grid candidate generation (port of deepvcp_tpu/ops/voxelize.py).

grid_size = round(2r/s) + 1 points per axis; `centered` gives the symmetric
offsets (j - (gs-1)/2) * s of the D12 fix, otherwise the reference's
asymmetric -r - s/2 + s*j.
"""

from __future__ import annotations

import numpy as np
import torch


def _offsets_np(search_radius: float, voxel_len: float, centered: bool) -> np.ndarray:
    gs = int(round(2.0 * search_radius / voxel_len)) + 1
    if centered:
        ax = voxel_len * (np.arange(gs) - (gs - 1) / 2.0)
    else:
        ax = -search_radius - voxel_len / 2.0 + voxel_len * np.arange(gs)
    gx, gy, gz = np.meshgrid(ax, ax, ax, indexing="ij")
    return np.stack([gx, gy, gz], axis=-1).reshape(-1, 3).astype(np.float32)


def candidate_offsets(search_radius: float, voxel_len: float, centered: bool,
                      device: torch.device) -> torch.Tensor:
    """[C, 3] float32 grid offsets around the origin, C = grid_size^3."""
    return torch.as_tensor(_offsets_np(search_radius, voxel_len, centered), device=device)


def voxelize(points: torch.Tensor, search_radius: float, voxel_len: float,
             centered: bool = False) -> torch.Tensor:
    """points [..., 3] -> candidates [..., C, 3] on the points' device."""
    offsets = candidate_offsets(search_radius, voxel_len, centered, points.device)
    return points[..., None, :] + offsets.to(points.dtype)
