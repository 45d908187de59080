"""The port's pose solve and Registrar (deepvcp_tpu_torch/loss,
registration.py) against the JAX package on the same inputs and weights:
at DeepVCPConfig.tiny(), and with the kitti25-rot checkpoint on a 128-point
cloud, where the JAX CPU path's static band covers every point."""

import dataclasses
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig
from deepvcp_tpu import pretrained as jpretrained
from deepvcp_tpu.loss.registration import svd_refine as jsvd_refine
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.registration import Registrar as JRegistrar
from deepvcp_tpu_torch.data.synthetic import LidarLikeDataset, batch_iterator
from deepvcp_tpu_torch.loss import svd_refine
from deepvcp_tpu_torch.registration import Registrar

torch.set_num_threads(2)

POSE_ATOL = 1e-4   # R and t after two Kabsch solves per refinement
SCORE_ATOL = 1e-5  # trimmed mean 1-NN distances


@pytest.mark.parametrize("weighted", [False, True])
def test_svd_refine(weighted):
    rng = np.random.default_rng(0)
    x = rng.uniform(-2, 2, (2, 20, 3)).astype(np.float32)
    a = np.radians(7.0)
    R = np.array([[1, 0, 0], [0, np.cos(a), -np.sin(a)], [0, np.sin(a), np.cos(a)]], np.float32)
    y = x @ R.T + np.float32(0.3) + rng.normal(0, 0.01, x.shape).astype(np.float32)
    y[:, :3] += rng.uniform(-1, 1, (2, 3, 3)).astype(np.float32)   # outliers
    w = rng.uniform(0.2, 1.0, (2, 20)).astype(np.float32) if weighted else None
    want = jsvd_refine(jnp.asarray(x), jnp.asarray(y), 0.8, None if w is None else jnp.asarray(w))
    got = svd_refine(torch.from_numpy(x), torch.from_numpy(y), 0.8,
                     None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.R.numpy(), np.asarray(want.R), atol=POSE_ATOL)
    np.testing.assert_allclose(got.t.numpy(), np.asarray(want.t), atol=POSE_ATOL)
    for b in range(2):
        assert set(got.inlier_idx[b].tolist()) == set(np.asarray(want.inlier_idx[b]).tolist())
        assert not set(got.inlier_idx[b].tolist()) & {0, 1, 2}


def _compare(out_t, out_j):
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.scores.numpy(), np.asarray(out_j.scores), atol=SCORE_ATOL)
    np.testing.assert_array_equal(out_t.keypoints.numpy(), np.asarray(out_j.keypoints))
    np.testing.assert_allclose(out_t.vcps.numpy(), np.asarray(out_j.vcps), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.saliency.numpy(), np.asarray(out_j.saliency), atol=1e-4)
    for b in range(out_t.R.shape[0]):
        assert set(out_t.inlier_idx[b].tolist()) == set(np.asarray(out_j.inlier_idx[b]).tolist())


@pytest.fixture(scope="module")
def tiny():
    """Tiny config (f32 selection), flax-initialised variables and a pair."""
    cfg = dataclasses.replace(DeepVCPConfig.tiny(use_normal=False), knn_select_dtype=None)
    ds = LidarLikeDataset(num_clouds=2, num_points=cfg.num_points, max_range=1.5, seed=3,
                          max_rotation_deg=4.0, max_translation=0.1)
    src, tgt, _, _ = next(batch_iterator(ds, 2, shuffle=False))
    variables = jax.device_get(jax.jit(JDeepVCP(cfg=cfg).init)(
        jax.random.key(0), src, tgt, np.tile(np.eye(3, dtype=np.float32), (2, 1, 1)),
        np.zeros((2, 3), np.float32)))
    return cfg, variables, src, tgt


@pytest.mark.parametrize("guard,saliency", [(True, True), (False, False)])
def test_registrar_tiny(tiny, guard, saliency):
    cfg, variables, src, tgt = tiny
    kw = dict(refine_iters=2, guard=guard, use_saliency_weights=saliency)
    out_j = JRegistrar(cfg, variables, **kw)(jnp.asarray(src), jnp.asarray(tgt))
    out_t = Registrar(cfg, variables, "cpu", **kw)(torch.from_numpy(src), torch.from_numpy(tgt))
    assert out_t.scores.shape == (2, 3)
    _compare(out_t, out_j)


def test_registrar_kitti25_rot_small_cloud():
    """The committed checkpoint through the whole slice: both packages'
    registry registrar (refine_iters 3, saliency weights, guard) on a
    128-point lidar-like pair, with a non-identity init. The cloud has a
    1 m range so that SA neighbourhoods hold more than the point itself: at
    25 m a 128-point cloud leaves most points alone in their 0.1 m ball,
    their features and saliencies then tie exactly, and the two top-K
    break those ties differently."""
    N = 128
    cfg_j, variables = jpretrained.load("kitti25-rot", num_points=N)
    ds = LidarLikeDataset(num_clouds=1, num_points=N, max_range=1.0, seed=110,
                          max_rotation_deg=5.0, max_translation=0.5)
    src, tgt, R_gt, t_gt = next(batch_iterator(ds, 1, shuffle=False))
    R0, t0 = R_gt.copy(), (t_gt + 0.05).astype(np.float32)
    kw = dict(refine_iters=3, use_saliency_weights=True)
    out_j = JRegistrar(cfg_j, variables, **kw)(*map(jnp.asarray, (src, tgt, R0, t0)))
    from deepvcp_tpu_torch import pretrained

    reg = pretrained.registrar("kitti25-rot", device="cpu", num_points=N)
    assert (reg.refine_iters, reg.use_saliency_weights, reg.guard) == (3, True, True)
    out_t = reg(*map(torch.from_numpy, (src, tgt, R0, t0)))
    _compare(out_t, out_j)


def test_registrar_checks_device_and_warns_once_on_extent(tiny):
    cfg, variables, src, _ = tiny
    reg = Registrar(cfg, variables, "cpu")
    with pytest.raises(ValueError, match="registrar on cpu"):
        reg(torch.zeros(1, cfg.num_points, 3, device="meta"), torch.from_numpy(src))
    big = torch.from_numpy(src[:1] * 10.0)   # extent ~30 > 1.5 x spatial_extent 4
    with pytest.warns(UserWarning, match="spatial_extent"):
        reg(big, big)
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        reg(big, big)
