"""Training loop (port of deepvcp_tpu/train/trainer.py).

The train step is the JAX `build_train_step`: the forward in training mode
(BatchNorm on batch statistics, running statistics updated; or, with
`freeze_batch_stats`, on the running statistics, left as they are), the
two-pass SVD loss, optax's global-norm clip and Adam at the scheduled
learning rate. The model holds the parameters and BatchNorm statistics and
is updated in place; `TrainState` holds the optimizer and the step count.
Checkpoints are the port's own `torch.save` of model, optimizer and step,
each with the JAX trainer's `.arch.json` provenance and `latest.json` resume
marker. Metrics keep the JAX keys and stay on the device between log points.

With a ("data", "point") mesh (parallel.make_mesh) the step is data
parallel: each data rank runs its B / data pairs, BatchNorm's statistics
and the loss's mean residual are those of the global batch (reduced over
the data group with autograd), and the gradients are all-reduced over the
data group before the clip and Adam, so every rank takes the single-device
step of the global batch. `Trainer.fit` runs the heartbeat and stall
watchdog of parallel/heartbeat.py with cfg.heartbeat_interval > 0, and
under a process group only rank 0 writes checkpoints and metrics.
"""

from __future__ import annotations

import dataclasses
import json
import math
import os
import warnings
from typing import Callable, Dict, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
from deepvcp_tpu_torch.data.synthetic import rotation_geodesic_deg, translation_error
from deepvcp_tpu_torch.loss import deepvcp_loss, svd_refine
from deepvcp_tpu_torch.models import DeepVCP, batch_norm_group
from deepvcp_tpu_torch.train.metrics import MetricsLogger
from deepvcp_tpu_torch.train.optim import clip_by_global_norm_, global_norm, learning_rate_schedule, make_adam
from deepvcp_tpu_torch.utils.rotations import random_small_rotation


@dataclasses.dataclass
class TrainState:
    optimizer: torch.optim.Adam
    step: int = 0


def create_train_state(model: DeepVCP, cfg: TrainConfig
                       ) -> Tuple[TrainState, Callable[[int], float]]:
    """A fresh Adam over the model's parameters at step 0, and the learning
    rate schedule (step -> lr) the train step applies."""
    schedule = learning_rate_schedule(cfg)
    return TrainState(optimizer=make_adam(model.parameters(), schedule(0))), schedule


def _pose_generator(seed: int, step: int) -> torch.Generator:
    """A CPU generator seeded from (seed ^ 0x5EED, step): deterministic and
    resume-stable, like the JAX key fold_in(key(seed ^ 0x5EED), step)."""
    mixed = np.random.SeedSequence([seed ^ 0x5EED, step]).generate_state(1, np.uint64)[0]
    return torch.Generator().manual_seed(int(mixed))


def _train_init_pose(cfg: TrainConfig, step: int, R_gt: torch.Tensor, t_gt: torch.Tensor,
                     shard: Tuple[int, int] = (0, 1)) -> Tuple[torch.Tensor, torch.Tensor]:
    """The warm-start pose fed to the model during training: (R_gt, 0) in
    reference mode; with init_translation="gt" and/or jitter, a pose sampled
    around ground truth (see TrainConfig). Draws from torch, not jax.random:
    same distribution, other numbers. `shard` (index, count): R_gt and t_gt
    are rows index of count equal shards of the global batch; the jitter is
    drawn for the whole global batch, as on one device, and these rows are
    taken from it."""
    if cfg.init_translation not in ("zero", "gt"):
        raise ValueError(
            f"init_translation must be 'zero' or 'gt', got {cfg.init_translation!r}")
    t_init = t_gt if cfg.init_translation == "gt" else torch.zeros_like(t_gt)
    if cfg.init_rot_jitter_deg <= 0 and cfg.init_trans_jitter <= 0:
        return R_gt, t_init
    gen = _pose_generator(cfg.seed, step)
    B = t_gt.shape[0]
    rows = slice(shard[0] * B, (shard[0] + 1) * B)
    R_init = R_gt
    if cfg.init_rot_jitter_deg > 0:
        dR = random_small_rotation(gen, B * shard[1], math.radians(cfg.init_rot_jitter_deg))
        R_init = dR[rows].to(R_gt) @ R_gt
    if cfg.init_trans_jitter > 0:
        j = cfg.init_trans_jitter
        t_jitter = torch.rand((B * shard[1], 3), generator=gen) * (2 * j) - j
        t_init = t_init + t_jitter[rows].to(t_gt)
    return R_init, t_init


def build_train_step(model: DeepVCP, schedule: Callable[[int], float], cfg: TrainConfig,
                     mesh=None):
    """The train step: (state, src, tgt, R_gt, t_gt[, R_init, t_init]) ->
    (new_state, metrics). The warm-start pose is sampled from the step count
    unless given. Updates the model's parameters (and, unless
    cfg.freeze_batch_stats, its BatchNorm running statistics) in place.

    With a mesh the batch is this rank's rows of the global batch (its data
    shard): BatchNorm's training statistics and the loss's mean residual are
    reduced over the data group within the step's forward, the gradients
    are averaged over it before the clip (each rank's loss is its share of
    the global loss, whose mean over the group is the global one, and the
    reductions' autograd sums every rank's part of the gradient), and the
    metrics are the global batch's."""
    data_group, shards, index = None, 1, 0
    if mesh is not None:
        from deepvcp_tpu_torch.parallel.mesh import DATA_AXIS, axis_group, axis_index, axis_size

        data_group = axis_group(mesh, DATA_AXIS)
        shards, index = axis_size(mesh, DATA_AXIS), axis_index(mesh, DATA_AXIS)

    def train_step(state: TrainState, src, tgt, R_gt, t_gt, R_init=None, t_init=None):
        if (R_init is None) != (t_init is None):
            raise ValueError("pass both R_init and t_init, or neither")
        if R_init is None:
            R_init, t_init = _train_init_pose(cfg, state.step, R_gt, t_gt, (index, shards))
        opt = state.optimizer
        # fine-tune mode: BatchNorm consumes the running statistics and
        # never updates them (eval() only gates BN here)
        model.train(not cfg.freeze_batch_stats)
        opt.zero_grad(set_to_none=True)
        with batch_norm_group(data_group):
            kp, vcp, aux = model(src, tgt, R_init, t_init)
        res = deepvcp_loss(
            kp, vcp, R_gt, t_gt, alpha=cfg.alpha, inlier_ratio=cfg.inlier_ratio,
            weights=aux["keypoint_saliency"] if cfg.use_saliency_weights else None,
            vcp_weight=cfg.vcp_loss_weight, rot_weight=cfg.rot_loss_weight, group=data_group)
        res.loss.backward()
        params = [p for group in opt.param_groups for p in group["params"]]
        for p in params:
            # jax.grad gives zeros where no gradient reaches (the saliency
            # layer without saliency weights); Adam still decays their moments
            if p.grad is None:
                p.grad = torch.zeros_like(p)
        grads = [p.grad for p in params]
        if data_group is not None:
            flat = torch.cat([g.reshape(-1) for g in grads])
            dist.all_reduce(flat, group=data_group)
            flat /= shards
            for g, part in zip(grads, torch.split(flat, [g.numel() for g in grads])):
                g.copy_(part.view_as(g))
        if cfg.grad_clip_norm > 0:
            grad_norm = clip_by_global_norm_(grads, cfg.grad_clip_norm)
        else:
            grad_norm = global_norm(grads)
        for group in opt.param_groups:
            group["lr"] = schedule(state.step)
        opt.step()
        metrics = {
            "loss": res.loss.detach(),
            "l1": res.l1.detach(),
            "mean_residual": res.mean_residual.detach(),
            "vcp_l1": res.vcp_l1.detach(),
            "rre_deg": torch.mean(rotation_geodesic_deg(res.R.detach(), R_gt)),
            "rte": torch.mean(translation_error(res.t.detach(), t_gt)),
            "grad_norm": grad_norm.detach(),
        }
        if data_group is not None:
            # mean_residual and grad_norm are the global batch's already
            keys = ("loss", "l1", "vcp_l1", "rre_deg", "rte")
            means = torch.stack([metrics[k].float() for k in keys])
            dist.all_reduce(means, group=data_group)
            metrics.update(zip(keys, means / shards))
        return TrainState(optimizer=opt, step=state.step + 1), metrics

    return train_step


def make_train_step(model: DeepVCP, schedule: Callable[[int], float], cfg: TrainConfig,
                    mesh=None):
    """The train step. With a ("data", "point") mesh (parallel.make_mesh):
    the model's parameters and buffers are broadcast from rank 0, and the
    step is build_train_step's data-parallel one: each rank
    passes its rows of the global batch (parallel.shard_batch) and gets the
    global batch's step and metrics. The ranks of one point group share
    their pairs; the model's knn_mesh, where set, runs their candidate KNN
    as the ring."""
    if mesh is not None:
        from deepvcp_tpu_torch.parallel.mesh import broadcast_module

        broadcast_module(model)
    return build_train_step(model, schedule, cfg, mesh)


def make_eval_step(model: DeepVCP, cfg: TrainConfig):
    """(src, tgt, R_gt, t_gt) -> (metrics, (R, t)), two operating points per
    batch as in JAX: warm-started at the training distribution's centre
    (rre_deg / rte, with the training objective as loss) and GT-free from
    identity with the unsupervised solve (gt_free_rre_deg / gt_free_rte).
    Encodes once and corresponds twice: the encoding does not depend on the
    pose."""

    @torch.no_grad()
    def eval_step(src, tgt, R_gt, t_gt):
        model.eval()
        t_warm = t_gt if cfg.init_translation == "gt" else torch.zeros_like(t_gt)
        enc = model.encode(src, tgt)
        kp, vcp, aux = model.correspond(enc, R_gt, t_warm)
        res = deepvcp_loss(
            kp, vcp, R_gt, t_gt, alpha=cfg.alpha, inlier_ratio=cfg.inlier_ratio,
            weights=aux["keypoint_saliency"] if cfg.use_saliency_weights else None,
            vcp_weight=cfg.vcp_loss_weight, rot_weight=cfg.rot_loss_weight)
        eye = torch.eye(3, dtype=src.dtype, device=src.device).expand(src.shape[0], 3, 3)
        kp0, vcp0, _ = model.correspond(enc, eye, torch.zeros_like(t_gt))
        free = svd_refine(kp0, vcp0, cfg.inlier_ratio)
        return {
            "loss": res.loss,
            "vcp_l1": res.vcp_l1,
            "rre_deg": torch.mean(rotation_geodesic_deg(res.R, R_gt)),
            "rte": torch.mean(translation_error(res.t, t_gt)),
            "gt_free_rre_deg": torch.mean(rotation_geodesic_deg(free.R, R_gt)),
            "gt_free_rte": torch.mean(translation_error(free.t, t_gt)),
        }, (res.R, res.t)

    return eval_step


def _add(agg: Optional[Dict[str, torch.Tensor]], m: Dict[str, torch.Tensor]):
    return dict(m) if agg is None else {k: agg[k] + m[k] for k in agg}


class Trainer:
    """Epoch loop with checkpointing and metrics.

    Under an initialised process group only rank 0 writes checkpoints,
    latest.json and metrics; the other ranks wait for it at a barrier. The
    step is unsharded, as the JAX Trainer's: a data-parallel step is
    make_train_step(mesh=...)'s."""

    def __init__(self, model_cfg: DeepVCPConfig, train_cfg: TrainConfig,
                 device: torch.device, metrics: Optional[MetricsLogger] = None):
        from deepvcp_tpu_torch.parallel.multihost import is_primary_host

        self.model_cfg = model_cfg
        self.cfg = train_cfg
        self.device = torch.device(device)
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(train_cfg.seed)
            self.model = DeepVCP(model_cfg)
        self.model.to(self.device)
        self.primary = is_primary_host()
        if metrics is None:
            metrics = MetricsLogger(train_cfg.metrics_path if self.primary else None,
                                    echo=self.primary)
        self.metrics = metrics
        self.state: Optional[TrainState] = None
        self._train_step = None
        self._eval_step = None

    # -- checkpointing ------------------------------------------------------
    def _checkpoint_dir(self) -> str:
        return os.path.abspath(self.cfg.checkpoint_dir)

    def save_checkpoint(self, tag: str, epoch: Optional[int] = None) -> str:
        """torch.save of model, optimizer and step to checkpoint_dir/tag, with
        tag.arch.json beside it; an epoch-tagged save also moves the
        latest.json resume marker. Under a process group rank 0 writes and
        every rank returns after it has (the ranks' states are equal)."""
        path = os.path.join(self._checkpoint_dir(), tag)
        if self.primary:
            os.makedirs(self._checkpoint_dir(), exist_ok=True)
            torch.save({"model": self.model.state_dict(),
                        "optimizer": self.state.optimizer.state_dict(),
                        "step": self.state.step}, path)
            # the semantic config fields that change the forward without
            # changing parameter shapes; load_checkpoint warns on a mismatch
            with open(path + ".arch.json", "w") as fh:
                json.dump(self._arch_fingerprint(), fh)
            if epoch is not None:
                with open(os.path.join(self._checkpoint_dir(), "latest.json"), "w") as fh:
                    json.dump({"tag": tag, "epoch": epoch, "step": self.state.step}, fh)
        if dist.is_initialized():
            dist.barrier()
        return path

    def latest_checkpoint(self) -> Optional[dict]:
        """The resume marker written by save_checkpoint, or None."""
        marker = os.path.join(self._checkpoint_dir(), "latest.json")
        if not os.path.exists(marker):
            return None
        with open(marker) as fh:
            info = json.load(fh)
        info["path"] = os.path.join(self._checkpoint_dir(), info["tag"])
        return info

    def _arch_fingerprint(self) -> dict:
        """The JAX trainer's fingerprint: the model-config fields that alter
        forward semantics while keeping the parameters shape-compatible."""
        c = self.model_cfg
        return {
            "centered_grid": c.centered_grid,
            "keypoint_selection": c.keypoint_selection,
            "dfe_src_neighbors": c.dfe_src_neighbors,
            "derotate_tgt_neighborhoods": c.derotate_tgt_neighborhoods,
            "group_radius": c.group_radius,
            "search_radius": c.search_radius,
            "voxel_len": c.voxel_len,
            "num_keypoints": c.num_keypoints,
            "num_neighbors": c.num_neighbors,
            "keypoint_pool_mult": c.keypoint_pool_mult,
            "sa_radii": [l.radius for l in c.sa_layers],
        }

    def load_checkpoint(self, path: str) -> None:
        arch_path = os.path.abspath(path) + ".arch.json"
        if os.path.exists(arch_path):
            with open(arch_path) as fh:
                saved = json.load(fh)
            cur = self._arch_fingerprint()
            diff = {k: (saved.get(k), cur[k]) for k in cur if saved.get(k) != cur[k]}
            if diff:
                warnings.warn(
                    f"checkpoint {path} was trained under different forward "
                    f"semantics (saved vs current): {diff} — the parameter "
                    f"shapes match but the weights will compute under a "
                    f"mismatched architecture. Set the listed DeepVCPConfig "
                    f"fields to the saved values to restore faithfully.",
                    stacklevel=2)
        else:
            warnings.warn(
                f"checkpoint {path} has no architecture provenance "
                f"({os.path.basename(arch_path)} missing)", stacklevel=2)
        ckpt = torch.load(os.path.abspath(path), map_location=self.device, weights_only=True)
        self.model.load_state_dict(ckpt["model"])
        self.state.optimizer.load_state_dict(ckpt["optimizer"])
        self.state.step = int(ckpt["step"])

    # -- loops --------------------------------------------------------------
    def setup(self, retrain_path: Optional[str] = None) -> None:
        self.state, schedule = create_train_state(self.model, self.cfg)
        self._train_step = make_train_step(self.model, schedule, self.cfg)
        self._eval_step = make_eval_step(self.model, self.cfg)
        if retrain_path:
            self.load_checkpoint(retrain_path)

    def _to_device(self, batch) -> Tuple[torch.Tensor, ...]:
        return tuple(torch.from_numpy(np.asarray(a)).to(self.device) for a in batch)

    def train_epoch(self, batches: Iterator, epoch: int) -> Dict[str, float]:
        """One epoch. The running metric sum stays on the device; the host
        reads it every `log_every` steps and once at the end."""
        agg = None
        n = 0
        for i, batch in enumerate(batches):
            self.state, m = self._train_step(self.state, *self._to_device(batch))
            agg = _add(agg, m)
            n += 1
            if (i + 1) % self.cfg.log_every == 0:
                host_m = {k: float(v) for k, v in m.items()}
                self.metrics.log({"kind": "train", "epoch": epoch, "batch": i, **host_m})
        if agg is None:
            return {}
        return {k: float(v) / n for k, v in agg.items()}

    def evaluate(self, batches: Iterator, epoch: int = -1) -> Dict[str, float]:
        """Held-out eval pass; one host read at the end."""
        agg = None
        n = 0
        for batch in batches:
            m, _ = self._eval_step(*self._to_device(batch))
            agg = _add(agg, m)
            n += 1
        if agg is None:
            return {}
        out = {k: float(v) / n for k, v in agg.items()}
        self.metrics.log({"kind": "eval", "epoch": epoch, **out})
        return out

    def fit(self, make_train_batches, make_eval_batches=None, resume: bool = False) -> None:
        """make_train_batches(epoch) -> iterator of (src, tgt, R, t) numpy
        batches. With resume=True, restart after the epoch of the latest
        checkpoint marker in checkpoint_dir (batches are seeded per epoch,
        so the data order continues as it would have).

        With cfg.heartbeat_interval > 0 the loop also runs the failure
        detector of parallel/heartbeat.py, as the JAX trainer does: a
        heartbeat under checkpoint_dir/heartbeats, the startup barrier, and
        a watchdog scan once per epoch, so that a dead or wedged peer fails
        this process loudly instead of hanging in a collective. The process
        index is the rank (0 of 1 without a process group)."""
        from deepvcp_tpu_torch.parallel.multihost import host_shard_info

        start_epoch = 0
        if resume:
            info = self.latest_checkpoint()
            if info is not None and info.get("epoch") is not None:
                self.load_checkpoint(info["path"])
                start_epoch = int(info["epoch"]) + 1
                self.metrics.log({"kind": "resume", "epoch": start_epoch,
                                  "step": info.get("step", -1)})
        heartbeat = watchdog = None
        if self.cfg.heartbeat_interval > 0:
            from deepvcp_tpu_torch.parallel.heartbeat import Heartbeat, Watchdog, wait_for_all_hosts

            rank, world = host_shard_info()
            hb_dir = os.path.join(self.cfg.checkpoint_dir, "heartbeats")
            heartbeat = Heartbeat(hb_dir, rank, interval=self.cfg.heartbeat_interval).start()
            wait_for_all_hosts(hb_dir, world)
            stale = self.cfg.heartbeat_stale_after
            watchdog = Watchdog(hb_dir, world, rank, stale_after=stale,
                                step_stale_after=4 * stale, grace_period=stale)
        try:
            for epoch in range(start_epoch, self.cfg.num_epochs):
                avg = self.train_epoch(make_train_batches(epoch), epoch)
                self.metrics.log({"kind": "epoch", "epoch": epoch, **avg})
                if heartbeat is not None:
                    heartbeat.update(self.state.step)
                    watchdog.scan()
                if (epoch + 1) % self.cfg.checkpoint_every_epochs == 0:
                    self.save_checkpoint(f"epoch_{epoch}", epoch=epoch)
                if make_eval_batches is not None:
                    self.evaluate(make_eval_batches(epoch), epoch)
            self.save_checkpoint("final", epoch=self.cfg.num_epochs - 1)
        finally:
            if heartbeat is not None:
                heartbeat.stop()
