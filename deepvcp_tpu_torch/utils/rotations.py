"""Random warm-start jitter (counterpart of
deepvcp_tpu/utils/rotations.py::random_small_rotation).

Drawn from a torch.Generator, so it does not give jax.random's numbers for
the same seed: tests that compare with JAX hand the JAX pose in."""

from __future__ import annotations

import torch


def random_small_rotation(generator: torch.Generator, batch: int,
                          max_angle_rad: float) -> torch.Tensor:
    """[batch, 3, 3] float32 rotations on the generator's device: uniform
    random axis, angle ~ U[0, max_angle_rad], by Rodrigues' formula."""
    dev = generator.device
    axis = torch.randn(batch, 3, generator=generator, device=dev)
    axis = axis / (torch.linalg.norm(axis, dim=-1, keepdim=True) + 1e-12)
    ang = torch.rand(batch, generator=generator, device=dev) * max_angle_rad
    kx, ky, kz = axis.unbind(-1)
    zeros = torch.zeros_like(kx)
    K = torch.stack([
        torch.stack([zeros, -kz, ky], dim=-1),
        torch.stack([kz, zeros, -kx], dim=-1),
        torch.stack([-ky, kx, zeros], dim=-1),
    ], dim=-2)                                            # [B, 3, 3]
    s = torch.sin(ang)[:, None, None]
    c = torch.cos(ang)[:, None, None]
    eye = torch.eye(3, device=dev).expand(batch, 3, 3)
    return eye + s * K + (1.0 - c) * (K @ K)
