"""Two-pass trimmed Kabsch pose solve and the training loss (port of
deepvcp_tpu/loss/registration.py::svd_refine, deepvcp_loss). Gradients
flow through both Kabsch solves and the inlier gathers, as in JAX."""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from deepvcp_tpu_torch.ops import apply_rigid, kabsch


class RegistrationResult(NamedTuple):
    loss: torch.Tensor           # scalar
    R: torch.Tensor              # [B, 3, 3] refined rotation
    t: torch.Tensor              # [B, 3] refined translation
    l1: torch.Tensor             # scalar: alpha term
    mean_residual: torch.Tensor  # scalar: (1 - alpha) term
    vcp_l1: torch.Tensor         # scalar: direct per-keypoint VCP error term
    rot_fro: torch.Tensor        # scalar: rotation Frobenius error term


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


def deepvcp_loss(x: torch.Tensor, y_pred: torch.Tensor, R_true: torch.Tensor,
                 t_true: torch.Tensor, alpha: float = 0.5, inlier_ratio: float = 0.8,
                 weights: Optional[torch.Tensor] = None, vcp_weight: float = 0.0,
                 rot_weight: float = 0.0, group=None) -> RegistrationResult:
    """alpha * L1(y_true_in, y2) + (1 - alpha) * |mean(y2 - y_true_in)| on the
    trimmed inliers, with y2 their second-pass fit; plus vcp_weight * the
    mean per-keypoint L1 of the VCPs and rot_weight * the mean
    sqrt(||R2 - R_true||_F^2 + 1e-12). x, y_pred [B, N, 3] keypoints and
    VCPs; R_true [B, 3, 3], t_true [B, 3]; weights [B, N] or None.

    `group`: a process group whose ranks hold the other pairs of the batch.
    The mean residual is then the batch's: its signed sum and count are
    all-reduced over the group (with autograd) before the absolute value;
    each rank's mean of its own would give another loss and gradient. The
    other terms stay this rank's means, which equal shards average into the
    batch's (so does the loss: its mean over the group is the batch's)."""
    ref = svd_refine(x, y_pred, inlier_ratio, weights)
    y2 = apply_rigid(ref.x_in, ref.R, ref.t)
    y_true_in = apply_rigid(ref.x_in, R_true, t_true)
    l1 = torch.mean(torch.abs(y_true_in - y2))
    residual = y2 - y_true_in
    if group is None:
        mean_res = torch.abs(torch.mean(residual))
    else:
        from torch.distributed.nn.functional import all_reduce

        sums = all_reduce(torch.stack([residual.sum(), residual.new_tensor(residual.numel())]),
                          group=group)
        mean_res = torch.abs(sums[0] / sums[1])
    vcp_l1 = torch.mean(torch.abs(apply_rigid(x, R_true, t_true) - y_pred))
    # the +1e-12 keeps the gradient bounded at zero rotation error
    rot_fro = torch.mean(torch.sqrt(
        torch.sum(torch.square(ref.R - R_true), dim=(-2, -1)) + 1e-12))
    loss = (alpha * l1 + (1.0 - alpha) * mean_res
            + vcp_weight * vcp_l1 + rot_weight * rot_fro)
    return RegistrationResult(loss=loss, R=ref.R, t=ref.t, l1=l1, mean_residual=mean_res,
                              vcp_l1=vcp_l1, rot_fro=rot_fro)
