"""Pair construction (counterpart of deepvcp_tpu/data/transforms.py): the
self-supervised augmentation the datasets share. Numpy on a numpy
Generator, so the same seeds give the JAX package's arrays bit for bit."""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from deepvcp_tpu_torch.utils.rotations import random_bounded_rotation, random_rotation


def random_pose(rng: np.random.Generator, max_translation: float = 1.0,
                max_rotation_deg: Optional[float] = None) -> Tuple[np.ndarray, np.ndarray]:
    """(R [3,3], t [3]) float64; full-SO(3) Euler sampling when
    max_rotation_deg is None, else a bounded rotation (geodesic angle
    uniform in [0, max_rotation_deg])."""
    if max_rotation_deg is None:
        R = random_rotation(rng)
    else:
        R = random_bounded_rotation(rng, max_rotation_deg)
    t = rng.uniform(-max_translation, max_translation, size=3)
    return R, t


def make_pair(points: np.ndarray, rng: np.random.Generator,
              normals: Optional[np.ndarray] = None, max_translation: float = 1.0,
              max_rotation_deg: Optional[float] = None, noise_std: float = 0.0):
    """(src, tgt = src @ R.T + t (+ Gaussian noise on the target), R, t), all
    float32; with normals, src and tgt are [N, 6] (the target's normals
    rotate, untranslated)."""
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


def resample(points: np.ndarray, n: int, rng: np.random.Generator) -> np.ndarray:
    """Exactly n rows: a random subsample without replacement, or with
    replacement when the cloud has fewer than n points; unchanged when it
    has n."""
    m = points.shape[0]
    if m == n:
        return points
    idx = rng.choice(m, size=n, replace=m < n)
    return points[idx]
