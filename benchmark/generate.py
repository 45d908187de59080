"""The traffic generator: a pool of LiDAR-like pairs made from the run's
seed, as a traffic file's parameters ask.

A frozen copy of the port's lidar_like_cloud, random_bounded_rotation and
make_pair (deepvcp_tpu_torch/data/synthetic.py, utils/rotations.py,
data/transforms.py), so that the yardstick does not move when the
program's generator does; benchmark/tests/test_generate.py holds the copy
equal to the port's bit for bit. Every seed gives the same sizes: `pool`
pairs of `num_points` points each, with another geometry and another pose.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np


class Pool(NamedTuple):
    src: np.ndarray   # [P, N, 3] float32
    tgt: np.ndarray   # [P, N, 3] float32, src @ R.T + t
    R: np.ndarray     # [P, 3, 3] float32 ground truth (never shown to the program)
    t: np.ndarray     # [P, 3] float32


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


def random_bounded_rotation(rng: np.random.Generator, max_angle_deg: float) -> np.ndarray:
    """Uniform random axis, geodesic angle uniform in [0, max_angle_deg]
    (Rodrigues' formula), float64."""
    axis = rng.standard_normal(3)
    angle = rng.uniform(0.0, np.radians(max_angle_deg))
    axis = axis / (np.linalg.norm(axis) + 1e-30)
    kx, ky, kz = axis
    K = np.array([[0.0, -kz, ky], [kz, 0.0, -kx], [-ky, kx, 0.0]], dtype=np.float64)
    return np.eye(3) + np.sin(angle) * K + (1.0 - np.cos(angle)) * (K @ K)


def make_pair(points: np.ndarray, rng: np.random.Generator, max_translation: float,
              max_rotation_deg: float):
    """(src, tgt = src @ R.T + t, R, t), all float32, under a bounded pose."""
    R = random_bounded_rotation(rng, max_rotation_deg)
    t = rng.uniform(-max_translation, max_translation, size=3)
    tgt = points @ R.T + t
    return (points.astype(np.float32), tgt.astype(np.float32),
            R.astype(np.float32), t.astype(np.float32))


def make_pool(seed: int, traffic: dict, num_points: int) -> Pool:
    """The run's pairs: traffic["pool"] clouds of num_points points, made as
    LidarLikeDataset(num_clouds=pool, num_points, max_range, seed=seed) makes
    them, each paired under the pose that LidarLikeDataset.sample(i,
    default_rng((seed, 0, i))) draws with the traffic's max_rotation_deg and
    max_translation (the held set of the campaign that trained the weights)."""
    pool = int(traffic["pool"])
    rng = np.random.default_rng(seed)
    clouds = [lidar_like_cloud(rng, num_points, max_range=float(traffic["max_range"]))
              for _ in range(pool)]
    pairs = [make_pair(cloud, np.random.default_rng((seed, 0, i)),
                       max_translation=float(traffic["max_translation"]),
                       max_rotation_deg=float(traffic["max_rotation_deg"]))
             for i, cloud in enumerate(clouds)]
    return Pool(*(np.stack(parts) for parts in zip(*pairs)))
