"""Farthest-point sampling (port of deepvcp_tpu/ops/sampling.py).

Deterministic: it starts from `start_idx` and breaks ties by the lowest
index. On the card every call is one launch of kernel K3
(ops/kernels/fps.py, csrc/fps.cu); on the CPU it is the plain loop. The
JAX `use_pallas` switch and its environment variable are the TPU's and
have no counterpart here.
"""

from __future__ import annotations

import torch

from deepvcp_tpu_torch.ops.kernels import fps


def farthest_point_sample(xyz: torch.Tensor, npoint: int, start_idx: int = 0) -> torch.Tensor:
    """xyz [B, N, 3] -> [B, npoint] int64 indices into N, on xyz's device.
    npoint <= N (beyond it every distance is 0 and index 0 repeats)."""
    return fps.farthest_point_sample(xyz.float().contiguous(), npoint, start_idx)
