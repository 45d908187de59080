"""The port's global SO(3) initializer (deepvcp_tpu_torch/initializer.py)
against the JAX package's (deepvcp_tpu/initializer.py) on the same numpy
clouds, on the CPU, at small sizes."""

import numpy as np
import pytest
import torch

from deepvcp_tpu.data import LidarLikeDataset as JLidarLikeDataset
from deepvcp_tpu.initializer import so3_global_init as jso3_global_init
from deepvcp_tpu.initializer import super_fibonacci_rotations as jsuper_fibonacci_rotations
from deepvcp_tpu_torch.data import (
    LidarLikeDataset, SyntheticDataset, batch_iterator, rotation_geodesic_deg)
from deepvcp_tpu_torch.initializer import (
    GlobalInit, super_fibonacci_rotations, so3_global_init)

torch.set_num_threads(2)

GRID_ATOL = 1e-6   # the grid: float64 on the host in both, then cast to f32
# R and t after 3 + 4 ICP iterations (each a weighted Kabsch solve in f32):
# the two frameworks sum the 3x3 moments and the distance tiles in
# different orders, so the poses agree to f32 rounding carried through
# seven solves, on pairs where one hypothesis wins by a clear margin
POSE_ATOL = 1e-4
SCORE_ATOL = 1e-5
SMALL = dict(n_rotations=128, n_src=64, n_tgt=256)


def _pairs(kind, B, N, seed):
    if kind == "lidar":
        ds = LidarLikeDataset(num_clouds=B, num_points=N, max_range=1.0, seed=seed,
                              noise_std=0.01)
    else:
        ds = SyntheticDataset(num_clouds=B, num_points=N, extent=1.0, seed=seed,
                              noise_std=0.01)
    return next(batch_iterator(ds, B, epoch=0, seed=0, shuffle=False))


def test_super_fibonacci_matches_jax():
    got = super_fibonacci_rotations(64)
    assert got.dtype == torch.float32 and got.shape == (64, 3, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(jsuper_fibonacci_rotations(64)),
                               atol=GRID_ATOL)
    eye = torch.eye(3).expand(64, 3, 3)
    assert torch.allclose(got @ got.transpose(1, 2), eye, atol=1e-5)


def test_lidar_pairs_match_jax_cloud_for_cloud():
    """The port's lidar generator is the JAX one: the same clouds feed both
    initializers below."""
    src, tgt, R, t = _pairs("lidar", 2, 512, 103)
    jds = JLidarLikeDataset(num_clouds=2, num_points=512, max_range=1.0, seed=103,
                            noise_std=0.01)
    from deepvcp_tpu.data import batch_iterator as jbatch_iterator

    for a, b in zip((src, tgt, R, t), next(jbatch_iterator(jds, 2, epoch=0, seed=0,
                                                           shuffle=False))):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("kind,seed", [("lidar", 103), ("lidar", 7), ("cube", 102)])
def test_matches_jax(kind, seed):
    src, tgt, R_gt, _ = _pairs(kind, 2, 512, seed)
    want = jso3_global_init(src, tgt, **SMALL)
    got = so3_global_init(torch.from_numpy(src), torch.from_numpy(tgt), **SMALL)
    assert isinstance(got, GlobalInit)
    assert got.R.shape == (2, 3, 3) and got.t.shape == (2, 3) and got.score.shape == (2,)
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=POSE_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=POSE_ATOL)
    np.testing.assert_allclose(got.score.numpy(), np.asarray(want.score), atol=SCORE_ATOL)


def test_result_does_not_depend_on_sweep_chunk():
    """Each hypothesis is solved on its own, so the chunking (here with an
    identity-padded last chunk: 100 rotations in chunks of 16 or 48) changes
    nothing."""
    src, tgt, _, _ = (torch.from_numpy(a) for a in _pairs("lidar", 2, 300, 5))
    kw = dict(n_rotations=100, n_src=48, n_tgt=200, top_p=16)
    whole = so3_global_init(src, tgt, sweep_chunk=100, **kw)
    for chunk in (16, 48):
        part = so3_global_init(src, tgt, sweep_chunk=chunk, **kw)
        for a, b in zip(part, whole):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)


def test_full_so3_pairs_enter_basin():
    """tests/test_initializer.py::test_full_so3_pairs_enter_basin on the
    port: full-SO(3) uniform-cube pairs land inside the refiner's basin."""
    ds = SyntheticDataset(num_clouds=4, num_points=512, extent=1.0, seed=102)
    src, tgt, R_gt, t_gt = (torch.from_numpy(a) for a in
                            next(batch_iterator(ds, 4, epoch=0, seed=0)))
    init = so3_global_init(src, tgt, n_tgt=512)
    rre = rotation_geodesic_deg(init.R, R_gt)
    rte = torch.linalg.norm(init.t - t_gt, dim=-1)
    assert rre.mean() < 5.0, (rre, rte)
    assert (rre < 10.0).all(), rre
    assert rte.mean() < 0.1, rte
