"""Synthetic pairs without JAX: a numpy copy of the synthetic datasets
(deepvcp_tpu/data/datasets.py SyntheticDataset, lidar_like_cloud,
LidarLikeDataset, batch_iterator), giving the same arrays bit for bit from
the same seeds. The pose sampling is data/transforms.py's and the pose
metrics utils/rotations.py's, re-exported here.
"""

from __future__ import annotations

from typing import Iterator, Optional, Tuple

import numpy as np

from deepvcp_tpu_torch.data.datasets import RegistrationPair
from deepvcp_tpu_torch.data.transforms import make_pair
from deepvcp_tpu_torch.utils.rotations import (  # noqa: F401
    random_bounded_rotation,
    random_rotation,
    rotation_geodesic_deg,
    translation_error,
)


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

    def sample(self, index: int, rng: np.random.Generator) -> RegistrationPair:
        return RegistrationPair(*make_pair(
            self.clouds[index], rng,
            normals=None if self.normals is None else self.normals[index],
            max_translation=self.max_translation,
            max_rotation_deg=self.max_rotation_deg, noise_std=self.noise_std))


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
                   shuffle: bool = True, host_id: int = 0,
                   num_hosts: int = 1) -> Iterator[Tuple[np.ndarray, ...]]:
    """Yield (src [B,N,3], tgt [B,N,3], R [B,3,3], t [B,3]) numpy batches,
    each pair seeded by (seed, epoch, index); drops a ragged last batch.
    With num_hosts > 1 each host (data rank) reads the disjoint stride
    host_id::num_hosts of the shuffled index stream."""
    order = np.arange(len(dataset))
    if shuffle:
        np.random.default_rng((seed, epoch)).shuffle(order)
    order = order[host_id::num_hosts]
    for start in range(0, len(order) - len(order) % batch_size, batch_size):
        pairs = [dataset.sample(int(i), np.random.default_rng((seed, epoch, int(i))))
                 for i in order[start:start + batch_size]]
        yield tuple(np.stack(parts) for parts in zip(*pairs))
