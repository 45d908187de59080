"""Two-level candidate-neighbour grouping (port of
deepvcp_tpu/ops/two_level.py).

The flat path selects each of the K*C candidates' k nearest target points
from the whole cloud. All C candidates of one keypoint lie in a cube of
half-width `grid_reach` around the warm-started keypoint, so their
neighbours come from one small neighbourhood. Two levels use that:

  1. keypoint level: the T target rows nearest each warm keypoint (a
     [K, N] selection tile), gathered once into a [B, K, T, D] table;
  2. candidate level: each candidate's k nearest rows WITHIN its keypoint's
     table, selected in keypoint-local coordinates (|values| bounded by the
     table's radius, so a bf16 selection tile is safe at any absolute cloud
     scale), then gathered from the table by kernel K4
     (ops/kernels/onehot_gather.py), whose backward is K5, or, with
     use_kernel=False (use_pallas_onehot_gather=False, the JAX
     `_onehot_gather_xla`), by torch.gather with autograd's backward.

A candidate's true k-NN is found iff it lies in its keypoint's top-T ball;
tests/test_torch_two_level.py and chip_smoke.py measure the recall. The
three stages are public so that a caller can time them apart.
"""

from __future__ import annotations

from typing import Optional

import torch

from deepvcp_tpu_torch.ops.grouping import index_points
from deepvcp_tpu_torch.ops.kernels.onehot_gather import onehot_gather_vjp
from deepvcp_tpu_torch.ops.knn import approx_knn


def keypoint_tables(tgt_xyz: torch.Tensor, rows: torch.Tensor, centers: torch.Tensor,
                    table_size: int, select_dtype: Optional[str] = None) -> torch.Tensor:
    """Level 1: the rows [B, N, D] of the min(table_size, N) target points
    nearest each center [B, K, 3] -> [B, K, T, D], nearest first.
    `select_dtype` is approx_knn's (None: f32)."""
    T = min(table_size, tgt_xyz.shape[-2])
    _, t_idx = approx_knn(tgt_xyz, centers, T, select_dtype=select_dtype)
    return index_points(rows, t_idx)


def table_neighbors(table_xyz: torch.Tensor, centers: torch.Tensor, cand: torch.Tensor,
                    k: int, select_dtype: Optional[str] = None) -> torch.Tensor:
    """Level 2: each candidate's k nearest table rows, [B, K, C, k] int64
    into T, ascending distance. table_xyz [B, K, T, 3], centers [B, K, 3],
    cand [B, K, C, 3]. d^2 = |c|^2 + |t|^2 - 2 c.t in coordinates local to
    the center (not centred on a cloud mean, unlike approx_knn); with
    `select_dtype` the product's inputs are rounded to it, the product
    accumulated in f32 (exact for bf16 inputs) and d^2 cast to it for the
    selection, as in JAX."""
    local_t = table_xyz - centers[:, :, None, :]
    local_c = cand - centers[:, :, None, :]
    s2 = torch.sum(local_c * local_c, dim=-1)[..., :, None]
    r2 = torch.sum(local_t * local_t, dim=-1)[..., None, :]
    if select_dtype:
        sel = getattr(torch, select_dtype)
        cross = local_c.to(sel).float() @ local_t.to(sel).float().transpose(-1, -2)
        d2 = (s2 + r2 - 2.0 * cross).to(sel)
    else:
        d2 = s2 + r2 - 2.0 * (local_c @ local_t.transpose(-1, -2))
    return torch.topk(d2, k, dim=-1, largest=False).indices


def gather_table_rows(table: torch.Tensor, l_idx: torch.Tensor,
                      use_kernel: bool = True) -> torch.Tensor:
    """The winning rows: table [B, K, T, D] f32, l_idx [B, K, C, k] ->
    [B, K, C, k, D], through K4 (K5 backward), or torch.gather."""
    B, K, C, k = l_idx.shape
    flat = l_idx.reshape(B, K, C * k)
    if use_kernel:
        out = onehot_gather_vjp(table, flat)
    else:
        out = torch.gather(table, 2, flat[..., None].expand(-1, -1, -1, table.shape[-1]))
    return out.reshape(B, K, C, k, -1)


def two_level_rows(tgt_xyz: torch.Tensor, rows: torch.Tensor, centers: torch.Tensor,
                   cand: torch.Tensor, k: int, table_size: int = 512,
                   select_dtype: Optional[str] = None,
                   center_select_dtype: Optional[str] = None,
                   use_kernel: bool = True) -> torch.Tensor:
    """Neighbour rows of every candidate through the two-level structure.

    tgt_xyz [B, N, 3]; rows [B, N, D] (xyz ++ features in the model);
    centers [B, K, 3] warm keypoints; cand [B, K, C, 3] -> [B, K, C, k, D],
    each candidate's rows by ascending distance. `select_dtype` is level 2's
    selection dtype, `center_select_dtype` level 1's. Exact selection at
    both levels, where the TPU took approx_min_k. `use_kernel` selects K4
    or torch.gather for the final gather."""
    table = keypoint_tables(tgt_xyz, rows, centers, table_size, center_select_dtype)
    l_idx = table_neighbors(table[..., :3], centers, cand, k, select_dtype)
    return gather_table_rows(table, l_idx, use_kernel)
