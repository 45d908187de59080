"""Two-pass trimmed Kabsch pose solve (port of
deepvcp_tpu/loss/registration.py::svd_refine). The training loss,
deepvcp_loss, comes with training (ROADMAP M7)."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deepvcp_tpu_torch.ops import apply_rigid, kabsch


class RefineResult(NamedTuple):
    R: torch.Tensor           # [B, 3, 3]
    t: torch.Tensor           # [B, 3]
    x_in: torch.Tensor        # [B, N', 3] inlier source points
    y_in: torch.Tensor        # [B, N', 3] inlier predicted correspondences
    inlier_idx: torch.Tensor  # [B, N'] indices into N


def svd_refine(x: torch.Tensor, y_pred: torch.Tensor, inlier_ratio: float = 0.8,
               weights: Optional[torch.Tensor] = None) -> RefineResult:
    """Kabsch on (x, y_pred), keep the `inlier_ratio` best-fitting
    correspondences by residual to that fit, and solve again on them
    (ground-truth-free). x, y_pred [B, N, 3]; weights [B, N] or None."""
    N = x.shape[-2]
    R1, t1 = kabsch(x, y_pred, weights)
    resid = torch.sum(torch.square(y_pred - apply_rigid(x, R1, t1)), dim=-1)
    num_in = max(int(N * inlier_ratio), 3)
    _, in_idx = torch.topk(resid, num_in, dim=-1, largest=False)
    take = lambda a: torch.gather(a, -2, in_idx[..., None].expand(-1, -1, a.shape[-1]))  # noqa: E731
    x_in, y_in = take(x), take(y_pred)
    w_in = torch.gather(weights, -1, in_idx) if weights is not None else None
    R2, t2 = kabsch(x_in, y_in, w_in)
    return RefineResult(R=R2, t=t2, x_in=x_in, y_in=y_in, inlier_idx=in_idx)
