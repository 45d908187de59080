"""Spatially sorted neighbour search (port of deepvcp_tpu/ops/neighbors.py).

The cloud is sorted once along one axis. Every point within radius r of a
query lies in the contiguous sorted slab [x_q - r, x_q + r]; the windowed
engine gathers a static window of W sorted positions from the slab's lower
bound and masks it by true 3-D distance. Points of an over-full slab beyond
the window are dropped: `slab_occupancy_stats` audits that, and the
Registrar's preflight warns about it.

Two selection orders live here and must not be confused with the dense
engine's (ops/grouping.py::query_ball_point): the windowed ball query keeps
the first `nsample` in-radius points in SORTED order, the dense one the
`nsample` lowest ORIGINAL indices.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
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


def searchsorted_batched(sorted_vals: torch.Tensor, queries: torch.Tensor) -> torch.Tensor:
    """Lower bound: for each query the first index i with
    sorted_vals[..., i] >= query. sorted_vals [..., N] (ascending), queries
    [..., S] -> [..., S] int64 in [0, N]. torch.searchsorted(side="left")
    returns exactly this lower bound on a sorted row, as the JAX package's
    fixed-depth binary search does."""
    return torch.searchsorted(sorted_vals.contiguous(), queries.contiguous(), side="left")


def window_for(num_points: int, radius: float, extent: float,
               safety: float = 8.0, minimum: int = 128) -> int:
    """Static window width: safety x the expected slab occupancy (uniform
    density along the sort axis), rounded up to a multiple of 128, capped at
    N. The windowed engine's window and the static band's half-width."""
    expected = num_points * min(2.0 * radius / max(extent, 1e-6), 1.0)
    w = max(int(expected * safety), minimum)
    w = -(-w // 128) * 128
    return min(w, num_points)


def slab_occupancy_stats(xyz, radius: float, axis: int = 0) -> dict:
    """Host audit of the static-window assumption: for every point, the
    number of cloud points within `radius` along the sort axis (the slab a
    window must cover). xyz [N, 3] or [B, N, 3], numpy or a tensor ->
    {max, p99, mean}. A window under-covers wherever max > window."""
    if isinstance(xyz, torch.Tensor):
        xyz = xyz.detach().cpu().numpy()
    xyz = np.asarray(xyz)
    if xyz.ndim == 2:
        xyz = xyz[None]
    occs = []
    for b in range(xyz.shape[0]):
        key = np.sort(xyz[b, :, axis])
        lo = np.searchsorted(key, key - radius, side="left")
        hi = np.searchsorted(key, key + radius, side="right")
        occs.append(hi - lo)
    occ = np.concatenate(occs)
    return {"max": int(occ.max()), "p99": int(np.percentile(occ, 99)),
            "mean": float(occ.mean())}


def _window_d2(cloud: SortedCloud, query_xyz: torch.Tensor,
               cand_idx: torch.Tensor) -> torch.Tensor:
    """Squared distance of each window candidate [B, S, W] to its query,
    ((dx*dx) + (dy*dy)) + (dz*dz) in that order, as the JAX package sums it,
    so in-radius masks agree bit for bit."""
    B = cand_idx.shape[0]
    flat = cand_idx.reshape(B, -1)
    d2 = None
    for c in range(3):
        col = torch.gather(cloud.xyz[..., c], 1, flat).reshape(cand_idx.shape)
        dc = col - query_xyz[..., c, None]
        dc = dc * dc
        d2 = dc if d2 is None else d2 + dc
    return d2


def _window_candidates(cloud: SortedCloud, query_xyz: torch.Tensor, radius: float,
                       window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each query's window of sorted positions from its slab's lower bound,
    clamped into the cloud: (cand_idx [B, S, W] int64, in_radius [B, S, W])."""
    N = cloud.key.shape[-1]
    lo = searchsorted_batched(cloud.key, query_xyz[..., cloud.axis] - radius)
    lo = torch.clamp_max(lo, max(N - window, 0))
    cand_idx = lo[..., None] + torch.arange(window, device=lo.device)
    cand_idx = torch.clamp_max(cand_idx, N - 1)
    r2 = float(np.float32(radius * radius))   # as JAX rounds the weak-typed r^2
    return cand_idx, _window_d2(cloud, query_xyz, cand_idx) <= r2


def select_first_k(mask: torch.Tensor, k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Positions of the first k True entries of each row: a cumsum, then the
    lower bound of 1..k in it. mask [..., W] bool -> (pos [..., k] int64,
    count [...] int64 hits). A row with fewer than k hits repeats its first
    hit. An empty row returns W - 1 everywhere (the lower bound past the
    end, clamped), as the JAX function does although its docstring says 0;
    its count of 0 marks it for masking."""
    W = mask.shape[-1]
    cum = torch.cumsum(mask.to(torch.int64), dim=-1)
    count = cum[..., -1]
    targets = torch.arange(1, k + 1, device=mask.device).expand(*mask.shape[:-1], k)
    pos = torch.clamp_max(searchsorted_batched(cum, targets), W - 1)
    return torch.where(targets <= count[..., None], pos, pos[..., :1]), count


def windowed_ball_query(cloud: SortedCloud, query_xyz: torch.Tensor, radius: float,
                        nsample: int, window: int, return_count: bool = False):
    """Ball query on the window: the first `nsample` in-radius points in
    sorted order, padded with the first hit. Returns idx [B, S, nsample]
    int64 SORTED-order indices and, with return_count, count [B, S]: 0 marks
    a query whose window held no in-radius point (its rows are garbage and
    must be masked)."""
    cand_idx, in_radius = _window_candidates(cloud, query_xyz, radius, window)
    pos, count = select_first_k(in_radius, nsample)
    idx = torch.gather(cand_idx, -1, pos)
    return (idx, count) if return_count else idx


def windowed_knn(cloud: SortedCloud, query_xyz: torch.Tensor, k: int,
                 window: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points among a window centred on each query's sorted
    position: (dist [B, S, k] ascending, idx [B, S, k] sorted-order
    indices). Ties go to the lower window position, as lax.top_k's."""
    N = cloud.key.shape[-1]
    center = searchsorted_batched(cloud.key, query_xyz[..., cloud.axis])
    lo = torch.clamp(center - window // 2, 0, max(N - window, 0))
    cand_idx = torch.clamp_max(lo[..., None] + torch.arange(window, device=lo.device), N - 1)
    d2, pos = torch.sort(_window_d2(cloud, query_xyz, cand_idx), dim=-1, stable=True)
    d2, pos = d2[..., :k], pos[..., :k]
    return torch.sqrt(torch.clamp_min(d2, 0.0)), torch.gather(cand_idx, -1, pos)
