"""Synthetic pairs without JAX: a numpy copy of the synthetic datasets and
their pose sampling (deepvcp_tpu/data/datasets.py SyntheticDataset,
lidar_like_cloud, LidarLikeDataset, batch_iterator; data/transforms.py
random_pose, make_pair; utils/rotations.py random_rotation,
random_bounded_rotation), giving the same arrays bit for bit from the same
seeds, plus the pose-error metrics in torch.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np
import torch


def _rot_x(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[1, 0, 0], [0, c, -s], [0, s, c]], dtype=np.float64)


def _rot_y(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, 0, s], [0, 1, 0], [-s, 0, c]], dtype=np.float64)


def _rot_z(theta: float) -> np.ndarray:
    c, s = np.cos(theta), np.sin(theta)
    return np.array([[c, -s, 0], [s, c, 0], [0, 0, 1]], dtype=np.float64)


def random_rotation(rng: np.random.Generator) -> np.ndarray:
    """R = Rx @ Ry @ Rz of three uniform Euler angles in [0, 2pi)."""
    tx, ty, tz = rng.uniform(0.0, 2.0 * np.pi, size=3)
    return _rot_x(tx) @ _rot_y(ty) @ _rot_z(tz)


def random_bounded_rotation(rng: np.random.Generator, max_angle_deg: float) -> np.ndarray:
    """Uniform random axis, geodesic angle uniform in [0, max_angle_deg]."""
    axis = rng.standard_normal(3)
    angle = rng.uniform(0.0, np.radians(max_angle_deg))
    axis = axis / (np.linalg.norm(axis) + 1e-30)
    kx, ky, kz = axis
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]], dtype=np.float64)
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def random_pose(rng: np.random.Generator, max_translation: float = 1.0,
                max_rotation_deg: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(R [3,3], t [3]) float64; full-SO(3) Euler sampling when
    max_rotation_deg is None."""
    if max_rotation_deg is None:
        R = random_rotation(rng)
    else:
        R = random_bounded_rotation(rng, max_rotation_deg)
    t = rng.uniform(-max_translation, max_translation, size=3)
    return R, t


def make_pair(points: np.ndarray, rng: np.random.Generator,
              normals: Optional[np.ndarray] = None, max_translation: float = 1.0,
              max_rotation_deg: Optional[float] = None, noise_std: float = 0.0):
    """(src, tgt = src @ R.T + t (+ noise), R, t), all float32; with normals,
    src and tgt are [N, 6] (the target's normals rotate, untranslated)."""
    R, t = random_pose(rng, max_translation, max_rotation_deg)
    tgt = points @ R.T + t
    if noise_std > 0.0:
        tgt = tgt + rng.normal(0.0, noise_std, tgt.shape)
    src = points
    if normals is not None:
        src = np.concatenate([points, normals], axis=-1)
        tgt = np.concatenate([tgt, normals @ R.T], axis=-1)
    return (src.astype(np.float32), tgt.astype(np.float32),
            R.astype(np.float32), t.astype(np.float32))


def lidar_like_cloud(rng: np.random.Generator, num_points: int, max_range: float = 10.0,
                     min_range: Optional[float] = None, ground_fraction: float = 0.6,
                     num_clusters: int = 12) -> np.ndarray:
    """A velodyne-like cloud with a ~1/range^2 density gradient: log-uniform
    ground ring plus Gaussian vertical clusters. [num_points, 3] float64."""
    if min_range is None:
        min_range = max_range / 20.0
    if not 0 < min_range < max_range:
        raise ValueError(f"need 0 < min_range < max_range, got {min_range}, {max_range}")
    scale = max_range
    n_ground = int(num_points * ground_fraction)
    n_struct = num_points - n_ground
    r = np.exp(rng.uniform(np.log(min_range), np.log(max_range), n_ground))
    az = rng.uniform(0.0, 2.0 * np.pi, n_ground)
    ground = np.stack(
        [r * np.cos(az), r * np.sin(az), rng.normal(0.0, 0.005 * scale, n_ground)], axis=-1)
    centers_r = np.exp(rng.uniform(np.log(min_range * 2), np.log(max_range), num_clusters))
    centers_az = rng.uniform(0.0, 2.0 * np.pi, num_clusters)
    centers = np.stack(
        [centers_r * np.cos(centers_az), centers_r * np.sin(centers_az),
         rng.uniform(0.0, 0.15 * scale, num_clusters)], axis=-1)
    which = rng.integers(0, num_clusters, n_struct)
    spread = rng.normal(0.0, 0.04 * scale, (n_struct, 3))
    return np.concatenate([ground, centers[which] + spread], axis=0)


class SyntheticDataset:
    """Uniform random clouds in [-extent, extent]^3 (with unit normals when
    use_normal); sample(i, rng) makes a pair from cloud i with a random
    pose."""

    def __init__(self, num_clouds: int = 64, num_points: int = 10000,
                 use_normal: bool = False, extent: float = 10.0,
                 max_translation: float = 1.0, max_rotation_deg: Optional[float] = None,
                 noise_std: float = 0.0, seed: int = 0):
        rng = np.random.default_rng(seed)
        self.clouds = [rng.uniform(-extent, extent, size=(num_points, 3))
                       for _ in range(num_clouds)]
        self.normals = None
        if use_normal:
            n = rng.standard_normal((num_clouds, num_points, 3))
            self.normals = n / np.linalg.norm(n, axis=-1, keepdims=True)
        self.max_translation = max_translation
        self.max_rotation_deg = max_rotation_deg
        self.noise_std = noise_std

    def __len__(self) -> int:
        return len(self.clouds)

    def sample(self, index: int, rng: np.random.Generator):
        return make_pair(self.clouds[index], rng,
                         normals=None if self.normals is None else self.normals[index],
                         max_translation=self.max_translation,
                         max_rotation_deg=self.max_rotation_deg, noise_std=self.noise_std)


class LidarLikeDataset(SyntheticDataset):
    """Synthetic velodyne-like clouds (radial density gradient)."""

    def __init__(self, num_clouds: int = 64, num_points: int = 10000,
                 max_range: float = 10.0, max_translation: float = 1.0,
                 max_rotation_deg: Optional[float] = None, noise_std: float = 0.0,
                 seed: int = 0):
        rng = np.random.default_rng(seed)
        self.clouds = [lidar_like_cloud(rng, num_points, max_range=max_range)
                       for _ in range(num_clouds)]
        self.normals = None
        self.max_translation = max_translation
        self.max_rotation_deg = max_rotation_deg
        self.noise_std = noise_std


def batch_iterator(dataset, batch_size: int, epoch: int = 0, seed: int = 0,
                   shuffle: bool = True) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield (src [B,N,3], tgt [B,N,3], R [B,3,3], t [B,3]) numpy batches,
    each pair seeded by (seed, epoch, index); drops a ragged last batch."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    for start in range(0, len(order) - len(order) % batch_size, batch_size):
        pairs = [dataset.sample(int(i), np.random.default_rng((seed, epoch, int(i))))
                 for i in order[start:start + batch_size]]
        yield tuple(np.stack(parts) for parts in zip(*pairs))


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
