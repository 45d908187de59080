"""The port's training step (deepvcp_tpu_torch/train) against the JAX
package's `build_train_step`, and its pieces against theirs: the
differentiable band-max pool, BatchNorm in training mode, `deepvcp_loss`,
the schedules and the clip, the eval step, Trainer checkpoints and the CLI.

The JAX model runs at DeepVCPConfig.tiny() (N=128) with its SA pooling
routed through the Pallas kernels in interpret mode, forward and backward,
which is the exact-slab semantics the port implements. The JAX CPU dispatch
would take the static torus band instead: at N=128 that band holds the one
128-point tile three times (band_tile 256, window 128), which the max
forgives but the static-band backward sums, so on CPU the JAX SA gradients
are three times the exact ones.
"""

import contextlib
import dataclasses
import functools
import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig
from deepvcp_tpu.config import SALayerConfig, TrainConfig
from deepvcp_tpu.loss import deepvcp_loss as jdeepvcp_loss
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.models import fused_sa as jfused_sa
from deepvcp_tpu.train import trainer as jtrainer
from deepvcp_tpu_torch.convert import flax_to_torch, optax_adam_to_torch
from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
from deepvcp_tpu_torch.loss import deepvcp_loss
from deepvcp_tpu_torch.models import DeepVCP, fused_sa
from deepvcp_tpu_torch.ops import sort_cloud
from deepvcp_tpu_torch.train import Trainer, TrainState, build_train_step, make_eval_step
from deepvcp_tpu_torch.train.optim import (
    ADAM_BETAS, ADAM_EPS, clip_by_global_norm_, learning_rate_schedule, load_adam_state,
    make_adam)

torch.set_num_threads(2)
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

LOSS_RTOL = 1e-5     # scalars after the forward and two SVD solves, f32
GRAD_RTOL = 1e-4     # a gradient tensor of the loss alone, relative to its max |g|
# A gradient tensor of the whole train step, relative to its max |g|. On
# these inputs both f32 implementations stray from a float64 run of the
# port's step by up to 1.7e-4 (the port) and 6.9e-4 (JAX) of a tensor's
# max, through the SVD backward: the two are held to each other at 2e-3.
STEP_GRAD_RTOL = 2e-3
STAT_ATOL = 1e-6     # BatchNorm running statistics
# Parameters against JAX's, in units of the largest lr applied so far, from
# an optimizer state past the warmup. A fresh Adam's first steps are near
# sign(g) for every element, so there a gradient of rounding noise moves
# an element by up to ~lr in either direction on each side (1.31 lr apart
# at most on these inputs): the bound is FRESH_ADAM_STEP_LR times the lr
# applied, summed over the steps. The update check below is the tight one.
PARAM_ATOL_LR = 0.05
FRESH_ADAM_STEP_LR = 1.5
UPDATE_RTOL = 1e-5   # a step's change against Adam's update from its moments, of the lr


def _perturb(variables, seed):
    """Nonzero biases and random BN statistics, so every tensor matters."""
    rng = np.random.default_rng(seed)

    def leaf(path, a):
        a = np.asarray(a)
        if path[-1].key == "var":
            return rng.uniform(0.5, 1.5, a.shape).astype(np.float32)
        return (a + 0.1 * rng.standard_normal(a.shape)).astype(np.float32)

    return {col: jax.tree_util.tree_map_with_path(leaf, tree)
            for col, tree in jax.device_get(variables).items()}


def _max_rel(got: np.ndarray, want: np.ndarray, floor: float = 1e-30) -> float:
    """max |got - want| over max(max |want|, floor)."""
    return float(np.max(np.abs(got - want)) / max(np.max(np.abs(want)), floor))


# -- the differentiable pool (K1 forward, K2 backward) ----------------------

def _sorted(rng, B, N, spread):
    xyz = rng.uniform(-spread, spread, (B, N, 3)).astype(np.float32)
    return np.take_along_axis(xyz, np.argsort(xyz[..., 0], axis=1)[..., None], axis=1)


@pytest.mark.parametrize("route", ["static_band", "pallas"])
def test_banded_max_pool_grad_matches_jax_vjp(route, monkeypatch):
    """jax.grad through the JAX banded_max_pool custom VJP against autograd
    through the port's pool, on a cloud whose slabs fit the static band
    (N=300, window 64, tile 64: no tile repeats in the band) and through
    the Pallas kernels. atol 1e-5."""
    if route == "pallas":
        monkeypatch.setattr(jfused_sa, "_use_band_kernel", lambda use_kernel: use_kernel)
    rng = np.random.default_rng(3)
    B, N, C, radius = 2, 300, 8, 0.5
    xyz = _sorted(rng, B, N, 4.0)
    u = rng.standard_normal((B, N, C)).astype(np.float32)

    def loss_j(uu):
        out = jfused_sa.banded_max_pool(jnp.asarray(xyz), uu, radius, 64, 64, True)
        return jnp.sum(jnp.sin(out) * jnp.cos(out * 0.5))

    want_out = np.asarray(jfused_sa.banded_max_pool(jnp.asarray(xyz), jnp.asarray(u), radius,
                                                    64, 64, True))
    want = np.asarray(jax.grad(loss_j)(jnp.asarray(u)))
    ut = torch.from_numpy(u).requires_grad_(True)
    out = fused_sa.banded_max_pool(torch.from_numpy(xyz), ut, radius)
    torch.sum(torch.sin(out) * torch.cos(out * 0.5)).backward()
    np.testing.assert_array_equal(out.detach().numpy(), want_out)
    np.testing.assert_allclose(ut.grad.numpy(), want, atol=1e-5)


def test_banded_max_pool_ties_get_full_cotangent():
    """Two points tied at a query's max each receive the whole cotangent
    (torch.amax would give each half)."""
    xyz = torch.tensor([[[0.0, 0, 0], [0.1, 0, 0], [5.0, 0, 0]]])
    u = torch.tensor([[[2.0], [2.0], [1.0]]]).repeat(1, 1, 16).requires_grad_(True)
    out = fused_sa.banded_max_pool(xyz, u, 0.5)
    out[:, 0].sum().backward()
    np.testing.assert_array_equal(u.grad[0, :, 0].numpy(), [1.0, 1.0, 0.0])


# -- BatchNorm in training mode ---------------------------------------------

@pytest.mark.parametrize("with_features", [False, True])
def test_sa_stage_train_mode_matches_flax(with_features):
    """One SA stage in train(): outputs and the running statistics after
    each of two successive calls, against flax apply(train=True,
    mutable=["batch_stats"])."""
    layer = SALayerConfig(npoint=-1, radius=0.4, nsample=16, mlp=(16, 16, 32))
    rng = np.random.default_rng(5)
    feats = [rng.standard_normal((2, 128, 8)).astype(np.float32) if with_features else None
             for _ in range(2)]
    xyzs = [np.asarray(sort_cloud(torch.from_numpy(_sorted(rng, 2, 128, 1.5))).xyz)
            for _ in range(2)]
    jm = jfused_sa.BandedSetAbstraction(layer, window=128, tile=256, use_pallas=True)
    v = _perturb(jm.init(jax.random.key(0), xyzs[0], feats[0]), 1)
    tm = fused_sa.BandedSetAbstraction(layer, 8 if with_features else None)
    tm.load_state_dict(flax_to_torch(v), strict=True)
    tm.train()
    for xyz, f in zip(xyzs, feats):
        want, upd = jm.apply(v, xyz, f, train=True, mutable=["batch_stats"])
        v = {"params": v["params"], "batch_stats": upd["batch_stats"]}
        got = tm(torch.from_numpy(xyz), None if f is None else torch.from_numpy(f))
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-4)
        stats = flax_to_torch(v)
        for name, buf in tm.named_buffers():
            if "running" in name:
                np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=STAT_ATOL,
                                           err_msg=name)


# -- the loss ---------------------------------------------------------------

@pytest.mark.parametrize("alpha,vcp_w,rot_w,weighted", [
    (0.5, 0.0, 0.0, False), (0.5, 1.0, 3.0, True), (0.2, 0.5, 0.0, True), (1.0, 0.0, 3.0, False)])
def test_deepvcp_loss_matches_jax(alpha, vcp_w, rot_w, weighted):
    """Every term and its gradient with respect to the VCPs and weights."""
    rng = np.random.default_rng(7)
    B, K = 2, 32
    x = rng.uniform(-2, 2, (B, K, 3)).astype(np.float32)
    a = np.radians(4.0)
    R = np.array([[np.cos(a), -np.sin(a), 0], [np.sin(a), np.cos(a), 0], [0, 0, 1]], np.float32)
    R = np.stack([R, R.T])
    t = rng.uniform(-0.3, 0.3, (B, 3)).astype(np.float32)
    y = (x @ R.transpose(0, 2, 1) + t[:, None] + rng.normal(0, 0.05, x.shape)).astype(np.float32)
    w = rng.uniform(0.1, 1.0, (B, K)).astype(np.float32) if weighted else None
    kw = dict(alpha=alpha, inlier_ratio=0.8, vcp_weight=vcp_w, rot_weight=rot_w)

    def jloss(yy, ww):
        return jdeepvcp_loss(jnp.asarray(x), yy, jnp.asarray(R), jnp.asarray(t),
                             weights=ww, **kw).loss

    want = jdeepvcp_loss(jnp.asarray(x), jnp.asarray(y), jnp.asarray(R), jnp.asarray(t),
                         weights=None if w is None else jnp.asarray(w), **kw)
    yt = torch.from_numpy(y).requires_grad_(True)
    wt = None if w is None else torch.from_numpy(w).requires_grad_(True)
    got = deepvcp_loss(torch.from_numpy(x), yt, torch.from_numpy(R), torch.from_numpy(t),
                       weights=wt, **kw)
    for field in ("loss", "l1", "mean_residual", "vcp_l1", "rot_fro", "R", "t"):
        np.testing.assert_allclose(getattr(got, field).detach().numpy(),
                                   np.asarray(getattr(want, field)), rtol=LOSS_RTOL, atol=1e-6,
                                   err_msg=field)
    got.loss.backward()
    gy, gw = jax.grad(jloss, argnums=(0, 1))(jnp.asarray(y),
                                             None if w is None else jnp.asarray(w))
    assert _max_rel(yt.grad.numpy(), np.asarray(gy)) < GRAD_RTOL
    if w is not None:
        assert _max_rel(wt.grad.numpy(), np.asarray(gw)) < GRAD_RTOL


# -- optimizer pieces -------------------------------------------------------

@pytest.mark.parametrize("total,warmup_steps", [(21760, 100), (50, 100), (400, 0)])
def test_cosine_schedule_matches_optax(total, warmup_steps):
    cfg = TrainConfig(lr_schedule="cosine", total_steps=total, warmup_steps=warmup_steps,
                      learning_rate=1e-3)
    warmup = min(warmup_steps, max(total // 10, 1))
    want = optax.warmup_cosine_decay_schedule(0.0, 1e-3, warmup, total, 1e-5)
    got = learning_rate_schedule(cfg)
    for step in sorted({0, 1, max(warmup - 1, 0), warmup, warmup + 7, total // 2, total,
                        total + 5}):
        # optax evaluates in f32, the port in f64
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-5, atol=1e-12,
                                   err_msg=f"step {step}")
    assert got(0) == 0.0 or warmup == 0
    assert learning_rate_schedule(TrainConfig(learning_rate=3e-4))(123) == 3e-4


@pytest.mark.parametrize("scale", [0.1, 1.0, 30.0])
def test_clip_by_global_norm_matches_optax(scale):
    """Below, at and above the threshold (norm 10)."""
    rng = np.random.default_rng(int(scale * 10))
    grads = [rng.standard_normal(s).astype(np.float32) for s in ((3, 4), (7,), (2, 2, 5))]
    norm = np.sqrt(sum(np.sum(g.astype(np.float64) ** 2) for g in grads))
    grads = [g * np.float32(10.0 * scale / norm) for g in grads]
    want, _ = optax.clip_by_global_norm(10.0).update([jnp.asarray(g) for g in grads],
                                                     optax.EmptyState())
    got = [torch.from_numpy(g.copy()) for g in grads]
    n = clip_by_global_norm_(got, 10.0)
    np.testing.assert_allclose(float(n), float(optax.global_norm(grads)), rtol=1e-6)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


# -- the training step: the slice as a whole --------------------------------

def _tiny_cfg():
    return dataclasses.replace(DeepVCPConfig.tiny(use_normal=True), knn_select_dtype=None)


def _batches(n_steps, seed):
    """Dense tiny clouds (extent 1.5 against SA radii 0.4-1.2, so saliencies
    do not tie), small motions, sensor noise; B=2."""
    data = SyntheticDataset(num_clouds=2 * n_steps, num_points=128, use_normal=True,
                            extent=1.5, max_translation=0.3, max_rotation_deg=10.0,
                            noise_std=0.01, seed=seed)
    return list(batch_iterator(data, 2, epoch=0, seed=seed))


CASES = {
    # the fine-tune recipe of the campaign (residual, jittered warm starts,
    # saliency-weighted solves, rotation term), BatchNorm on batch
    # statistics, a fresh Adam under warmup
    "residual": (dict(vcp_loss_weight=1.0, rot_loss_weight=3.0, lr_schedule="cosine",
                      warmup_steps=100, total_steps=21760, use_saliency_weights=True,
                      init_translation="gt", init_rot_jitter_deg=6.0,
                      init_trans_jitter=0.5), 0),
    # the same recipe with BatchNorm frozen, continued from a JAX optimizer
    # state past the warmup (Adam moments and counts carried over)
    "frozen_bn_mid_schedule": (dict(vcp_loss_weight=1.0, rot_loss_weight=3.0,
                                    lr_schedule="cosine", warmup_steps=100, total_steps=2000,
                                    use_saliency_weights=True, freeze_batch_stats=True,
                                    init_translation="gt", init_rot_jitter_deg=6.0,
                                    init_trans_jitter=0.5), 700),
}


def _mid_schedule_state(opt_state, count, rng):
    """The optax chain state with random Adam moments and every count set."""
    def fix(node):
        if isinstance(node, optax.ScaleByAdamState):
            return node._replace(
                count=jnp.int32(count),
                mu=jax.tree_util.tree_map(
                    lambda a: rng.normal(0, 1e-3, a.shape).astype(np.float32), node.mu),
                nu=jax.tree_util.tree_map(
                    lambda a: rng.uniform(1e-8, 1e-6, a.shape).astype(np.float32), node.nu))
        if isinstance(node, optax.ScaleByScheduleState):
            return node._replace(count=jnp.int32(count))
        if type(node) is tuple:
            return tuple(fix(c) for c in node)
        return node

    return fix(opt_state)


def _jax_grads(jm, tcfg):
    """jax.grad of the JAX train step's loss_fn, for the given pose, clipped
    as the step clips it."""
    def loss_fn(params, batch_stats, src, tgt, R, t, R_init, t_init):
        variables = {"params": params, "batch_stats": batch_stats}
        if tcfg.freeze_batch_stats:
            kp, vcp, aux = jm.apply(variables, src, tgt, R_init, t_init, train=False)
        else:
            (kp, vcp, aux), _ = jm.apply(variables, src, tgt, R_init, t_init, train=True,
                                         mutable=["batch_stats"])
        return jdeepvcp_loss(kp, vcp, R, t, alpha=tcfg.alpha, inlier_ratio=tcfg.inlier_ratio,
                             weights=aux["keypoint_saliency"] if tcfg.use_saliency_weights
                             else None, vcp_weight=tcfg.vcp_loss_weight,
                             rot_weight=tcfg.rot_loss_weight).loss

    clip = optax.clip_by_global_norm(tcfg.grad_clip_norm)
    return jax.jit(lambda *a: clip.update(jax.grad(loss_fn)(*a), optax.EmptyState())[0])


@pytest.mark.parametrize("case", list(CASES))
def test_train_step_matches_jax(case, monkeypatch):
    """Three steps from perturbed parameters: loss and metrics, gradients,
    parameters, BatchNorm statistics and Adam moments after every step.
    Gradients are compared relative to each tensor's max |g|, floored at 1%
    of the global gradient norm: a BatchNorm bias followed by another
    training-mode BatchNorm has an exact gradient of zero, and holds only
    rounding noise on both sides."""
    overrides, start = CASES[case]
    tcfg = TrainConfig(**overrides)
    cfg = _tiny_cfg()
    batches = _batches(3, seed=20 + start)
    jm = JDeepVCP(cfg=cfg)
    # initialise before routing the pooling through the (eager, slow)
    # interpreted Pallas kernels; the initial values are replaced anyway
    jstate, tx = jtrainer.create_train_state(jm, tcfg, batches[0])
    monkeypatch.setattr(jfused_sa, "_use_band_kernel", lambda use_kernel: use_kernel)
    v = _perturb({"params": jstate.params, "batch_stats": jstate.batch_stats}, 2)
    opt_state = tx.init(v["params"])
    if start:
        opt_state = _mid_schedule_state(opt_state, start, np.random.default_rng(4))
    jstate = jtrainer.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                                 opt_state=opt_state, step=jnp.int32(start))
    jstep = jax.jit(jtrainer.build_train_step(jm, tx, tcfg))
    jgrad = _jax_grads(jm, tcfg)

    model = DeepVCP(cfg)
    model.load_state_dict(flax_to_torch(v), strict=True)
    schedule = learning_rate_schedule(tcfg)
    opt = make_adam(model.parameters(), schedule(start))
    if start:
        load_adam_state(opt, model, optax_adam_to_torch(opt_state, model))
    state = TrainState(optimizer=opt, step=start)
    step_fn = build_train_step(model, schedule, tcfg)
    lrs = []

    for i, (src, tgt, R, t) in enumerate(batches):
        R_init, t_init = jtrainer._train_init_pose(tcfg, jnp.int32(start + i), jnp.asarray(R),
                                                   jnp.asarray(t))
        want_g = jgrad(jstate.params, jstate.batch_stats, src, tgt, R, t, R_init, t_init)
        jstate, jm_metrics = jstep(jstate, src, tgt, R, t)
        before = {n: p.detach().clone() for n, p in model.named_parameters()}
        state, metrics = step_fn(state, *map(torch.from_numpy, (src, tgt, R, t)),
                                 torch.tensor(np.asarray(R_init)), torch.tensor(np.asarray(t_init)))
        # optax's lr of this step: the schedule at the count before the update
        lrs.append(float(optax.warmup_cosine_decay_schedule(
            0.0, tcfg.learning_rate, min(tcfg.warmup_steps, max(tcfg.total_steps // 10, 1)),
            tcfg.total_steps, 0.01 * tcfg.learning_rate)(start + i)))
        assert schedule(start + i) == pytest.approx(lrs[-1], rel=1e-5, abs=1e-12)
        # each parameter moved by exactly Adam's update from its moments
        # (held against JAX's below) at that lr: none at all when it is 0
        for name, p in model.named_parameters():
            m = opt.state[p]
            c = float(m["step"])
            m_hat = m["exp_avg"].double() / (1 - ADAM_BETAS[0] ** c)
            v_hat = m["exp_avg_sq"].double() / (1 - ADAM_BETAS[1] ** c)
            want_delta = -lrs[-1] * m_hat / (v_hat.sqrt() + ADAM_EPS)
            got_delta = p.detach().double() - before[name].double()
            tol = UPDATE_RTOL * lrs[-1] + np.spacing(np.abs(p.detach().numpy()))
            assert np.all(np.abs((got_delta - want_delta).numpy()) <= tol), (i, name)
        # rre_deg is left out: the port's RRE formula differs from JAX's
        # arccos at near-zero angles (data/synthetic.py:rotation_geodesic_deg)
        for key in ("loss", "l1", "mean_residual", "vcp_l1", "rte", "grad_norm"):
            rtol = STEP_GRAD_RTOL if key == "grad_norm" else LOSS_RTOL
            np.testing.assert_allclose(float(metrics[key]), float(jm_metrics[key]),
                                       rtol=rtol, atol=1e-7, err_msg=f"step {i} {key}")
        want_grads = flax_to_torch({"params": want_g})
        floor = 0.01 * float(jm_metrics["grad_norm"])
        for name, p in model.named_parameters():
            assert _max_rel(p.grad.numpy(), want_grads[name].numpy(), floor) < STEP_GRAD_RTOL, \
                (i, name)
        want_state = flax_to_torch({"params": jstate.params, "batch_stats": jstate.batch_stats})
        got_state = model.state_dict()
        param_tol = PARAM_ATOL_LR * max(lrs) if start else FRESH_ADAM_STEP_LR * sum(lrs)
        for name, want_t in want_state.items():
            if name.endswith("num_batches_tracked"):
                continue
            tol = STAT_ATOL if "running" in name else param_tol
            np.testing.assert_allclose(got_state[name].numpy(), want_t.numpy(), rtol=0,
                                       atol=tol, err_msg=f"step {i} {name}")
        want_adam = optax_adam_to_torch(jstate.opt_state, model)
        floors = {k: 0.01 * float(np.sqrt(sum(np.sum(m[k].numpy() ** 2)
                                              for m in want_adam.values())))
                  for k in ("exp_avg", "exp_avg_sq")}
        for name, p in model.named_parameters():
            got_m = opt.state[p]
            assert float(got_m["step"]) == float(want_adam[name]["step"]) == start + i + 1
            for k, floor in floors.items():
                # the second moment squares the gradient's relative error
                rtol = STEP_GRAD_RTOL if k == "exp_avg" else 2 * STEP_GRAD_RTOL
                assert _max_rel(got_m[k].numpy(), want_adam[name][k].numpy(), floor) < rtol, \
                    (i, name, k)
    assert state.step == int(jstate.step) == start + 3


def test_eval_step_matches_jax():
    """Both operating points of make_eval_step, at perturbed weights. The
    warm-started rre_deg is left out (near-zero angle, formulas differ)."""
    cfg = _tiny_cfg()
    tcfg = TrainConfig(**CASES["residual"][0])
    src, tgt, R, t = _batches(1, seed=30)[0]
    jm = JDeepVCP(cfg=cfg)
    v = _perturb(jax.jit(functools.partial(jm.init, train=False))(
        jax.random.key(0), src, tgt, R, t), 3)
    jstate = jtrainer.TrainState(params=v["params"], batch_stats=v["batch_stats"],
                                 opt_state=None, step=jnp.int32(0))
    want, (jR, jt) = jtrainer.make_eval_step(jm, tcfg)(jstate, src, tgt, R, t)
    model = DeepVCP(cfg)
    model.load_state_dict(flax_to_torch(v), strict=True)
    got, (tR, tt) = make_eval_step(model, tcfg)(*map(torch.from_numpy, (src, tgt, R, t)))
    assert not model.training
    for key in ("loss", "vcp_l1", "rte", "gt_free_rte"):
        np.testing.assert_allclose(float(got[key]), float(want[key]), rtol=LOSS_RTOL, atol=1e-7,
                                   err_msg=key)
    np.testing.assert_allclose(float(got["gt_free_rre_deg"]), float(want["gt_free_rre_deg"]),
                               atol=1e-3)
    np.testing.assert_allclose(tR.numpy(), np.asarray(jR), atol=1e-5)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), atol=1e-5)


# -- Trainer and the CLI ----------------------------------------------------

def _trainer(tmp_path, name, epochs, **cfg_overrides):
    cfg = DeepVCPConfig.tiny(num_points=64, use_normal=False)
    tcfg = TrainConfig(num_epochs=epochs, checkpoint_dir=str(tmp_path / name),
                       metrics_path=str(tmp_path / name / "metrics.jsonl"), log_every=2,
                       lr_schedule="cosine", warmup_steps=2, total_steps=12,
                       use_saliency_weights=True, vcp_loss_weight=1.0, init_translation="gt",
                       init_rot_jitter_deg=6.0, init_trans_jitter=0.2)
    tr = Trainer(dataclasses.replace(cfg, **cfg_overrides), tcfg, device="cpu")
    tr.setup()
    return tr


def _train_batches(epoch):
    data = SyntheticDataset(num_clouds=4, num_points=64, extent=1.5, max_translation=0.3,
                            max_rotation_deg=10.0, seed=5)
    return batch_iterator(data, 1, epoch=epoch, seed=0)


def _same_state(a: Trainer, b: Trainer) -> None:
    assert a.state.step == b.state.step
    sa, sb = a.model.state_dict(), b.model.state_dict()
    for name in sa:
        assert torch.equal(sa[name], sb[name]), name
    for pa, pb in zip(a.model.parameters(), b.model.parameters()):
        for k in ("step", "exp_avg", "exp_avg_sq"):
            assert torch.equal(a.state.optimizer.state[pa][k], b.state.optimizer.state[pb][k]), k


def test_trainer_checkpoint_round_trip_and_resume(tmp_path):
    """A killed run resumed from its epoch checkpoint ends bit for bit where
    an uninterrupted run ends; save -> load restores model, optimizer and
    step; the first step (warmup lr 0) leaves the parameters unchanged."""
    full = _trainer(tmp_path, "full", epochs=2)
    before = {k: v.clone() for k, v in full.model.state_dict().items()}
    full.state, _ = full._train_step(full.state, *full._to_device(next(_train_batches(0))))
    for name, p in full.model.named_parameters():
        assert torch.equal(p, before[name]), name
    full = _trainer(tmp_path, "full", epochs=2)
    full.fit(_train_batches)
    assert full.state.step == 8
    records = [json.loads(line) for line in open(tmp_path / "full" / "metrics.jsonl")]
    assert {"train", "epoch"} <= {r["kind"] for r in records}
    assert {"loss", "l1", "mean_residual", "vcp_l1", "rre_deg", "rte", "grad_norm"} <= set(
        next(r for r in records if r["kind"] == "train"))

    killed = _trainer(tmp_path, "resumed", epochs=1)
    killed.fit(_train_batches)
    resumed = _trainer(tmp_path, "resumed", epochs=2)
    resumed.fit(_train_batches, resume=True)
    _same_state(resumed, full)

    loaded = _trainer(tmp_path, "full", epochs=2)
    loaded.load_checkpoint(str(tmp_path / "full" / "final"))
    _same_state(loaded, full)
    assert json.load(open(tmp_path / "full" / "latest.json"))["step"] == 8
    with pytest.warns(UserWarning, match="search_radius"):
        _trainer(tmp_path, "full", epochs=2, search_radius=0.5).load_checkpoint(
            str(tmp_path / "full" / "final"))


@contextlib.contextmanager
def _world_of_one():
    """A gloo process group of this process alone and its 1 x 1 mesh, torn
    down after."""
    import torch.distributed as dist

    from deepvcp_tpu_torch.parallel import initialize_multihost, make_mesh
    from deepvcp_tpu_torch.parallel.launch import free_port

    initialize_multihost(f"localhost:{free_port()}", 1, 0, device="cpu")
    try:
        yield make_mesh(1, 1, device="cpu")
    finally:
        dist.destroy_process_group()


def test_trainer_refuses_what_is_not_ported(tmp_path):
    """What was refused before the multi-device port: the step of
    make_train_step(mesh=...) on a 1 x 1 mesh equals the unsharded step over
    two steps (warmup lr 0, then lr > 0; jittered warm starts): loss and
    grad norm within LOSS_RTOL, parameters within 2.5 lr (a fresh Adam moves
    a rounding-level gradient by ~lr either way); the step's BatchNorm group
    does not outlive the step (an unsharded step of the same model runs
    after the group is gone); and Trainer.fit with a heartbeat under the
    process group writes its heartbeat file and rank 0's checkpoints."""
    from deepvcp_tpu_torch.train import make_train_step

    plain, sharded = _trainer(tmp_path, "plain", epochs=1), _trainer(tmp_path, "sharded", epochs=1)
    batches = [tuple(torch.from_numpy(a) for a in b) for b in _train_batches(0)][:2]
    with _world_of_one() as mesh:
        steps = {"plain": make_train_step(plain.model, learning_rate_schedule(plain.cfg), plain.cfg),
                 "sharded": make_train_step(sharded.model, learning_rate_schedule(sharded.cfg),
                                            sharded.cfg, mesh=mesh)}
        metrics = {k: [] for k in steps}
        for name, tr in (("plain", plain), ("sharded", sharded)):
            for batch in batches:
                tr.state, m = steps[name](tr.state, *batch)
                metrics[name].append({k: float(v) for k, v in m.items()})
        for a, b in zip(metrics["plain"], metrics["sharded"]):
            assert b["loss"] == pytest.approx(a["loss"], rel=LOSS_RTOL)
            assert b["grad_norm"] == pytest.approx(a["grad_norm"], rel=LOSS_RTOL)
        lr = learning_rate_schedule(plain.cfg)(1)
        assert lr > 0
        for (n, p), q in zip(plain.model.named_parameters(), sharded.model.parameters()):
            np.testing.assert_allclose(q.detach().numpy(), p.detach().numpy(),
                                       atol=2.5 * lr, err_msg=n)

        tr = _trainer(tmp_path, "heartbeat", epochs=1)
        tr.cfg = dataclasses.replace(tr.cfg, heartbeat_interval=0.2)
        tr.setup()
        tr.fit(_train_batches)
    after = make_train_step(sharded.model, learning_rate_schedule(sharded.cfg), sharded.cfg)
    sharded.state, m = after(sharded.state, *batches[0])
    assert np.isfinite(float(m["loss"]))
    ckpt = tmp_path / "heartbeat"
    assert (ckpt / "heartbeats" / "heartbeat_0.json").exists()
    assert (ckpt / "final").exists() and (ckpt / "epoch_0").exists()
    assert json.load(open(ckpt / "latest.json"))["step"] == 4


def _cli(tmp_path, *args):
    """Run the CLI in a fresh interpreter, and fail if it imported jax."""
    code = ("import runpy, sys\n"
            f"sys.argv = ['deepvcp_tpu_torch.train', *{list(args)!r}]\n"
            "runpy.run_module('deepvcp_tpu_torch.train', run_name='__main__')\n"
            "assert 'jax' not in sys.modules\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=tmp_path, capture_output=True,
                          text=True, timeout=300, env={**os.environ, "PYTHONPATH": ROOT})
    assert proc.returncode == 0, proc.stderr[-3000:]
    return proc.stdout


def test_cli_train_eval_and_resume(tmp_path):
    """python -m deepvcp_tpu_torch.train --tiny --dataset synthetic on CPU:
    one epoch of the residual recipe, --eval-only on its checkpoint, then
    --resume continuing to a second epoch."""
    common = ["--device", "cpu", "--tiny", "--dataset", "synthetic", "--num-points", "64",
              "--recipe", "residual", "--checkpoint-dir", "ck", "--metrics-path", "m.jsonl"]
    out = _cli(tmp_path, *common, "--epochs", "1")
    assert "Finished Training" in out
    assert (tmp_path / "ck" / "final_model").exists()
    assert (tmp_path / "ck" / "final_model.arch.json").exists()
    out = _cli(tmp_path, *common, "--eval-only", "-r", "ck/final_model")
    assert "gt_free_rre_deg" in out
    _cli(tmp_path, *common, "--epochs", "2", "--resume")
    kinds = [(r["kind"], r.get("epoch")) for r in
             (json.loads(line) for line in open(tmp_path / "m.jsonl"))]
    assert ("resume", 1) in kinds and ("epoch", 1) in kinds and ("epoch", 0) in kinds


@pytest.mark.parametrize("argv,match", [
    (["--dataset", "kitti"], "--root is required for kitti"),
    (["--dataset", "modelnet"], "--root is required for modelnet")])
def test_cli_refuses_what_is_not_ported(argv, match):
    """The file datasets need --root, as in the JAX CLI (their loaders are
    ported: tests/test_torch_data.py; --save-vis: tests/test_torch_vis.py)."""
    from deepvcp_tpu_torch.train.cli import main
    with pytest.raises(SystemExit, match=match):
        main(["--device", "cpu", "--tiny", *argv])
