"""Weighted Kabsch solve with the reflection fix (port of
deepvcp_tpu/ops/kabsch.py). Points are row vectors: y ~= x @ R.T + t.

The 3 x 3 SVD goes through ops/svd.py::svd: on the card without a gradient
to record, cuSOLVER's batched Jacobi SVD with torch.linalg.svd's bits and
no host sync (torch's own call reads every matrix's convergence back to
the host twice); elsewhere torch.linalg.svd itself."""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepvcp_tpu_torch.ops.svd import svd


def kabsch(x: torch.Tensor, y: torch.Tensor,
           weights: Optional[torch.Tensor] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, y [..., N, 3], weights [..., N] or None -> (R [..., 3, 3], t [..., 3])
    minimising the weighted squared residual of x @ R.T + t against y."""
    w = torch.ones(x.shape[:-1], dtype=x.dtype, device=x.device) if weights is None \
        else weights.to(x.dtype)
    w = w / (torch.sum(w, dim=-1, keepdim=True) + 1e-12)
    cx = torch.einsum("...n,...nc->...c", w, x)
    cy = torch.einsum("...n,...nc->...c", w, y)
    dx = x - cx[..., None, :]
    dy = y - cy[..., None, :]
    H = torch.einsum("...na,...n,...nb->...ab", dx, w, dy)
    u, _, vt = svd(H)
    v = vt.transpose(-1, -2)
    ut = u.transpose(-1, -2)
    # reflection fix: R = V diag(1, 1, det(V U^T)) U^T
    d = torch.sign(torch.linalg.det(v @ ut))
    z = torch.ones(x.shape[:-2] + (3,), dtype=x.dtype, device=x.device)
    z[..., 2] = d
    R = (v * z[..., None, :]) @ ut
    t = cy - torch.einsum("...ab,...b->...a", R, cx)
    return R, t


def apply_rigid(points: torch.Tensor, R: torch.Tensor, t: torch.Tensor) -> torch.Tensor:
    """y = R x + t for row-vector points [..., N, 3]."""
    return points @ R.transpose(-1, -2) + t[..., None, :]
