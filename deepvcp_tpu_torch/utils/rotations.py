"""Rotation helpers and pose-error metrics (counterpart of
deepvcp_tpu/utils/rotations.py).

The samplers are numpy on a numpy Generator and give the JAX package's
arrays bit for bit from the same seeds; the metrics take tensors.
`random_small_rotation` draws from a torch.Generator, so it does not give
jax.random's numbers for the same seed: tests that compare with JAX hand
the JAX pose in."""

from __future__ import annotations

import numpy as np
import torch


def rot_x(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def euler_to_matrix(tx: float, ty: float, tz: float) -> np.ndarray:
    """R = Rx @ Ry @ Rz, the reference datasets' composition."""
    return rot_x(tx) @ rot_y(ty) @ rot_z(tz)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """R = Rx @ Ry @ Rz of three uniform Euler angles in [0, 2pi)."""
    tx, ty, tz = rng.uniform(0.0, 2.0 * np.pi, size=3)
    return euler_to_matrix(tx, ty, tz)


def axis_angle_to_matrix(axis: np.ndarray, angle: float) -> np.ndarray:
    """Rodrigues' formula: rotation by `angle` (radians) about `axis`."""
    axis = np.asarray(axis, dtype=np.float64)
    axis = axis / (np.linalg.norm(axis) + 1e-30)
    kx, ky, kz = axis
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]], dtype=np.float64)
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def random_bounded_rotation(rng: np.random.Generator, max_angle_deg: float) -> np.ndarray:
    """Uniform random axis, geodesic angle uniform in [0, max_angle_deg]."""
    axis = rng.standard_normal(3)
    angle = rng.uniform(0.0, np.radians(max_angle_deg))
    return axis_angle_to_matrix(axis, angle)


def rotation_geodesic_deg(R_pred: torch.Tensor, R_true: torch.Tensor) -> torch.Tensor:
    """RRE: the angle of R_pred^T R_true in degrees, [...].

    The JAX metric takes arccos((tr(R_pred^T R_true) - 1) / 2), which in
    float32 rounds every angle below ~0.03 deg to 0. This evaluates the same
    angle as 2 asin(|R_pred - R_true|_F / (2 sqrt 2)), which stays resolved
    at small angles (|R_pred - R_true|_F = 2 sqrt(2) sin(angle / 2))."""
    fro = torch.linalg.norm(R_pred - R_true, dim=(-2, -1))
    return torch.rad2deg(2.0 * torch.arcsin(torch.clamp(fro / (2.0 * 2.0 ** 0.5), 0.0, 1.0)))


def translation_error(t_pred: torch.Tensor, t_true: torch.Tensor) -> torch.Tensor:
    """RTE: euclidean norm of the translation residual, [...]."""
    return torch.linalg.norm(t_pred - t_true, dim=-1)


def euler_xyz_deg(R: torch.Tensor) -> torch.Tensor:
    """Extrinsic x-y-z Euler angles in degrees (scipy's as_euler('xyz')),
    [..., 3]."""
    b = torch.arcsin(torch.clamp(-R[..., 2, 0], -1.0, 1.0))
    a = torch.atan2(R[..., 2, 1], R[..., 2, 2])
    c = torch.atan2(R[..., 1, 0], R[..., 0, 0])
    return torch.rad2deg(torch.stack([a, b, c], dim=-1))


def euler_error_deg(R_pred: torch.Tensor, R_true: torch.Tensor) -> torch.Tensor:
    """The reference's rotation error: the L2 norm of the difference of the
    extrinsic-xyz Euler angles in degrees, [...]."""
    return torch.linalg.norm(euler_xyz_deg(R_pred) - euler_xyz_deg(R_true), dim=-1)


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
