"""Spatial sort for the banded engine (port of deepvcp_tpu/ops/neighbors.py
::sort_cloud and window_for)."""

from __future__ import annotations

from typing import NamedTuple

import torch


class SortedCloud(NamedTuple):
    """A cloud sorted along one spatial axis."""

    xyz: torch.Tensor     # [B, N, 3] sorted by xyz[..., axis]
    key: torch.Tensor     # [B, N] the sort coordinate (ascending)
    perm: torch.Tensor    # [B, N] sorted index -> original index (int64)
    axis: int


def sort_cloud(xyz: torch.Tensor, axis: int = 0) -> SortedCloud:
    """Sort points along coordinate `axis`. Stable, like jnp.argsort, so
    equal keys keep their input order and the permutation matches JAX's."""
    perm = torch.argsort(xyz[..., axis], dim=-1, stable=True)
    xyz_sorted = torch.gather(xyz, 1, perm[..., None].expand(-1, -1, 3))
    return SortedCloud(xyz=xyz_sorted, key=xyz_sorted[..., axis], perm=perm, axis=axis)


def window_for(num_points: int, radius: float, extent: float,
               safety: float = 8.0, minimum: int = 128) -> int:
    """The JAX package's static band width for its CPU path: safety x the
    expected slab occupancy, rounded up to a multiple of 128, capped at N.
    The port never uses a static band (its kernel scans the exact slab);
    this says when the JAX CPU path and the port agree: when it returns N."""
    expected = num_points * min(2.0 * radius / max(extent, 1e-6), 1.0)
    w = max(int(expected * safety), minimum)
    w = -(-w // 128) * 128
    return min(w, num_points)
