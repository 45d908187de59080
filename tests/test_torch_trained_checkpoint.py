"""The trained-checkpoint regression on the port (counterpart of
tests/test_trained_checkpoint.py): campaign_r4's fine-grid checkpoint
(artifacts/campaign_r4/model_fine/final, trained at N = 10 000), served
through pretrained.campaign_registrar("campaign_r4-fine") at N = 1024 on
the JAX test's held-out sample, GT-free from identity with the guard and
refine_iters 2.

The first test asserts the JAX test's bounds on the port's default engine
(the exact slab, K1's plain version here). The second holds the port
against JAX's Registrar on the same sample. JAX on the CPU pools over its
static band whatever use_pallas_band_max says, and at N = 1024 that band
need not cover the slab, so the port runs its static band there
(use_pallas_band_max=False). Both sides select candidates in f32
(knn_select_dtype=None): the default bf16 tile breaks ties at the k-th
distance differently in the two packages (tests/test_torch_registration.py).
"""

import dataclasses
import os

import numpy as np
import pytest
import torch

from deepvcp_tpu_torch import pretrained
from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
from deepvcp_tpu_torch.utils.rotations import rotation_geodesic_deg

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
N = 1024
NAME = "campaign_r4-fine"
POSE_ATOL = 1e-4    # R and t after two guarded refinements (measured 3.6e-7)
SCORE_ATOL = 1e-5   # trimmed mean 1-NN distances


def held_sample():
    """The JAX test's sample: 2 unit-cube pairs, <= 10 deg, <= 0.5."""
    ds = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0, seed=100,
                          max_rotation_deg=10.0, max_translation=0.5)
    return next(batch_iterator(ds, 2, epoch=0, seed=0))


def registrar(**cfg_changes):
    return pretrained.campaign_registrar(
        NAME, device="cpu", cfg_changes={"num_points": N, **cfg_changes},
        use_saliency_weights=True, refine_iters=2)


def check_trained_accuracy_and_guard(out, R, t):
    """tests/test_trained_checkpoint.py's assertions (numpy in, host side)."""
    rre = rotation_geodesic_deg(out.R, R).cpu().numpy()
    rte = torch.linalg.norm(out.t - t, dim=-1).cpu().numpy()
    assert rre.max() <= 5.0, rre
    assert rte.max() <= 0.15, rte
    # the guard's accepted score can only improve: best-so-far over cols
    # 0..i is non-increasing, and it beats the identity-init score
    sc = out.scores.cpu().numpy()
    best = np.minimum.accumulate(sc, axis=1)
    assert (np.diff(best, axis=1) <= 1e-7).all(), sc
    assert (best[:, -1] < sc[:, 0] - 1e-4).all(), sc
    return rre, rte


@pytest.mark.skipif(not os.path.isdir(os.path.join(ROOT, pretrained.CAMPAIGN[NAME]["path"])),
                    reason="round-4 campaign checkpoint not present")
def test_trained_model_gt_free_accuracy_and_guard():
    reg = registrar()
    assert reg.cfg.use_pallas_band_max and (reg.refine_iters, reg.guard) == (2, True)
    src, tgt, R, t = (torch.from_numpy(a) for a in held_sample())
    check_trained_accuracy_and_guard(reg(src, tgt), R, t)


@pytest.mark.skipif(not os.path.isdir(os.path.join(ROOT, pretrained.CAMPAIGN[NAME]["path"])),
                    reason="round-4 campaign checkpoint not present")
def test_static_band_matches_jax_registrar():
    """Same sample, same checkpoint, one batched call each: pose within
    POSE_ATOL, guard scores within SCORE_ATOL, keypoints equal."""
    import jax.numpy as jnp

    from deepvcp_tpu import DeepVCPConfig
    from deepvcp_tpu import data as jdata
    from deepvcp_tpu import pretrained as jpretrained
    from deepvcp_tpu.registration import Registrar

    sample = held_sample()
    jds = jdata.SyntheticDataset(num_clouds=2, num_points=N, extent=1.0, seed=100,
                                 max_rotation_deg=10.0, max_translation=0.5)
    for got, want in zip(sample, next(jdata.batch_iterator(jds, 2, epoch=0, seed=0))):
        np.testing.assert_array_equal(got, want)

    reg = registrar(use_pallas_band_max=False, knn_select_dtype=None)
    src, tgt, R, t = (torch.from_numpy(a) for a in sample)
    out = reg(src, tgt)
    check_trained_accuracy_and_guard(out, R, t)

    # the config tests/test_trained_checkpoint.py builds, f32 selection
    cfg = dataclasses.replace(
        DeepVCPConfig(num_points=N, use_normal=False, spatial_extent=2.5, search_radius=0.6,
                      voxel_len=0.2), knn_select_dtype=None)
    assert dataclasses.asdict(cfg) == dataclasses.asdict(
        dataclasses.replace(reg.cfg, use_pallas_band_max=True))
    variables = jpretrained.load_variables(os.path.join(ROOT, pretrained.CAMPAIGN[NAME]["path"]))
    want = Registrar(cfg, variables, use_saliency_weights=True, refine_iters=2)(
        jnp.asarray(sample[0]), jnp.asarray(sample[1]))
    np.testing.assert_array_equal(out.keypoints.numpy(), np.asarray(want.keypoints))
    np.testing.assert_allclose(out.R.numpy(), np.asarray(want.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out.t.numpy(), np.asarray(want.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out.scores.numpy(), np.asarray(want.scores), atol=SCORE_ATOL)
