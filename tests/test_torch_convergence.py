"""The port's training actually learns: the counterparts of
tests/test_convergence.py, on the port's Trainer, with its recipes, data
and assertions. The data are the JAX test's arrays (the port's
SyntheticDataset draws them bit for bit); the weights are the port's own
random initialisation, so the trajectories differ from JAX's and only the
assertions carry over."""

import numpy as np
import torch

from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
from deepvcp_tpu_torch.loss import svd_refine
from deepvcp_tpu_torch.train import Trainer
from deepvcp_tpu_torch.utils.rotations import rotation_geodesic_deg, translation_error

torch.set_num_threads(2)


def _fixed_batch(ds):
    return tuple(torch.from_numpy(a) for a in next(batch_iterator(ds, 2, epoch=0, seed=0)))


def test_overfit_reduces_loss():
    """30 steps on one fixed pair: the mean loss of the last 5 is below 0.9x
    that of the first 5."""
    model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    train_cfg = TrainConfig(num_epochs=1, batch_size=2, learning_rate=3e-3, metrics_path=None,
                            log_every=1000)
    trainer = Trainer(model_cfg, train_cfg, device="cpu")
    trainer.setup()
    batch = _fixed_batch(SyntheticDataset(num_clouds=2, num_points=64, extent=2.0))
    losses = []
    for _ in range(30):
        trainer.state, m = trainer._train_step(trainer.state, *batch)
        losses.append(float(m["loss"]))
    first, last = np.mean(losses[:5]), np.mean(losses[-5:])
    assert np.isfinite(losses).all()
    assert last < first * 0.9, (first, last, losses[::5])


def gt_free_errors(model, src, tgt, R_gt, t_gt):
    """Mean (RRE deg, RTE) of the identity-init forward in eval mode and the
    unweighted trimmed Kabsch solve: the GT-free operating point."""
    model.eval()
    with torch.no_grad():
        eye = torch.eye(3).expand(src.shape[0], 3, 3)
        kp, vcp, _ = model(src, tgt, eye, torch.zeros_like(t_gt))
        ref = svd_refine(kp, vcp)
    model.train()
    return (float(torch.mean(rotation_geodesic_deg(ref.R, R_gt))),
            float(torch.mean(translation_error(ref.t, t_gt))))


def test_overfit_recovers_pose_gt_free():
    """With the direct VCP term the overfit pair is solved GT-free: after
    350 steps (tiny, N = 64, B = 2, cosine schedule) the eval-mode
    identity-init solve recovers the pose far better than at init."""
    steps = 350
    model_cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    train_cfg = TrainConfig(num_epochs=1, batch_size=2, learning_rate=3e-3, metrics_path=None,
                            log_every=10000, vcp_loss_weight=1.0, lr_schedule="cosine",
                            total_steps=steps, use_saliency_weights=True)
    trainer = Trainer(model_cfg, train_cfg, device="cpu")
    trainer.setup()
    # small-motion pairs, so that the identity-init candidate grid covers
    # the true correspondence
    ds = SyntheticDataset(num_clouds=2, num_points=64, extent=2.0, max_rotation_deg=5.0,
                          max_translation=0.4)
    src, tgt, R_gt, t_gt = _fixed_batch(ds)
    rre0, rte0 = gt_free_errors(trainer.model, src, tgt, R_gt, t_gt)
    for _ in range(steps):
        trainer.state, m = trainer._train_step(trainer.state, src, tgt, R_gt, t_gt)
    assert np.isfinite(float(m["loss"]))
    rre1, rte1 = gt_free_errors(trainer.model, src, tgt, R_gt, t_gt)
    # RRE is noise-limited over a unit lever arm: a sanity bound there, the
    # strong bound on RTE
    assert rte1 < 0.25 * rte0, (rte0, rte1)
    assert rte1 < 0.1, (rte0, rte1)
    assert rre1 < 2.0, (rre0, rre1)
