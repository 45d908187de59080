"""The port's odometry (deepvcp_tpu_torch/odometry) against the JAX
package's on the same numpy inputs: SO(3) maps, pose chaining, the pose
graph and its Gauss-Newton, landmark bundle adjustment, trajectory metrics,
register_sequence and run_odometry, and the CLI."""

import contextlib
import dataclasses
import json
import os
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig
from deepvcp_tpu import odometry as jodo
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.odometry import pose_graph as jpg
from deepvcp_tpu.registration import Registrar as JRegistrar
from deepvcp_tpu_torch import odometry as todo
from deepvcp_tpu_torch.data.synthetic import lidar_like_cloud
from deepvcp_tpu_torch.odometry import pose_graph as tpg
from deepvcp_tpu_torch.registration import Registrar

torch.set_num_threads(2)

SO3_ATOL = 1e-6     # float32 maps of the same formula
GN_ATOL = 1e-4      # poses after Gauss-Newton (the issue's bound)
METRIC_ATOL = 1e-5  # ATE / RPE


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _exp(w):
    return np.asarray(jodo.exp_so3(jnp.asarray(np.asarray(w, np.float32)[None])))[0]


def _trajectory(F, rng, step_scale=0.1):
    """Ground-truth absolute poses and the exact consecutive measurements
    (tests/test_odometry.py's _random_trajectory)."""
    R_abs, t_abs = [np.eye(3)], [np.zeros(3)]
    for _ in range(F - 1):
        R_abs.append(R_abs[-1] @ _exp(rng.uniform(-step_scale, step_scale, 3)))
        t_abs.append(t_abs[-1] + rng.uniform(-1, 1, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    R_rel = np.stack([R_abs[i + 1].T @ R_abs[i] for i in range(F - 1)])
    t_rel = np.stack([R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1]) for i in range(F - 1)])
    return R_abs, t_abs, R_rel, t_rel


def _noisy_loop_graph():
    """test_odometry.py's noisy 10-frame trajectory with exact loop closures
    0 -> 5 and 0 -> 9, and the chained (drifted) initial poses."""
    rng = np.random.default_rng(2)
    F = 10
    R_abs, t_abs, R_rel, t_rel = _trajectory(F, rng)
    R_rel_n = np.stack([R_rel[i] @ _exp(rng.normal(0, 0.02, 3)) for i in range(F - 1)])
    t_rel_n = t_rel + rng.normal(0, 0.05, t_rel.shape)
    extra = [(0, k, R_abs[k].T @ R_abs[0], R_abs[k].T @ (t_abs[0] - t_abs[k])) for k in (5, 9)]
    return R_abs, t_abs, R_rel_n.astype(np.float32), t_rel_n.astype(np.float32), extra


def test_so3_maps_match_jax():
    rng = np.random.default_rng(0)
    w = rng.uniform(-1.5, 1.5, (10, 3)).astype(np.float32)
    w[0] = 0.0
    w[1] = [1e-9, 0.0, 0.0]
    np.testing.assert_allclose(tpg.hat(_t(w)).numpy(), np.asarray(jpg.hat(jnp.asarray(w))),
                               atol=0)
    R_t, R_j = tpg.exp_so3(_t(w)), jpg.exp_so3(jnp.asarray(w))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=SO3_ATOL)
    np.testing.assert_allclose(tpg.log_so3(R_t).numpy(), np.asarray(jpg.log_so3(R_j)),
                               atol=SO3_ATOL)
    np.testing.assert_allclose(tpg.log_so3(R_t).numpy()[2:], w[2:], atol=1e-4)
    assert torch.isfinite(tpg.log_so3(R_t)).all()


def test_chain_poses_matches_jax():
    rng = np.random.default_rng(1)
    R_abs, t_abs, R_rel, t_rel = _trajectory(8, rng)
    R_t, t_t = tpg.chain_poses(_t(R_rel), _t(t_rel))
    R_j, t_j = jpg.chain_poses(jnp.asarray(R_rel, jnp.float32), jnp.asarray(t_rel, jnp.float32))
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=SO3_ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=SO3_ATOL)
    np.testing.assert_allclose(R_t.numpy(), R_abs, atol=1e-4)
    np.testing.assert_allclose(t_t.numpy(), t_abs, atol=1e-4)


def test_build_graph_with_loop_edges_matches_jax():
    _, _, R_rel, t_rel, extra = _noisy_loop_graph()
    w = np.linspace(0.5, 1.5, len(R_rel) + len(extra)).astype(np.float32)
    g_t = tpg.build_graph(_t(R_rel), _t(t_rel), extra_edges=extra, weights=_t(w))
    g_j = jpg.build_graph(jnp.asarray(R_rel), jnp.asarray(t_rel), extra_edges=extra,
                          weights=jnp.asarray(w))
    for field in jpg.PoseGraph._fields:
        np.testing.assert_array_equal(getattr(g_t, field).numpy(),
                                      np.asarray(getattr(g_j, field)), err_msg=field)
    assert g_t.edges_i.tolist()[-2:] == [0, 0] and g_t.edges_j.tolist()[-2:] == [5, 9]


def test_optimize_pose_graph_noisy_loop_matches_jax():
    """15 Gauss-Newton steps on the noisy loop-closed graph: the same poses
    as JAX within GN_ATOL, and a lower ATE than the chained start."""
    R_abs, t_abs, R_rel, t_rel, extra = _noisy_loop_graph()
    R0, t0 = tpg.chain_poses(_t(R_rel), _t(t_rel))
    R_t, t_t = tpg.optimize_pose_graph(tpg.build_graph(_t(R_rel), _t(t_rel), extra_edges=extra),
                                       R0, t0, num_iters=15)
    g_j = jpg.build_graph(jnp.asarray(R_rel), jnp.asarray(t_rel), extra_edges=extra)
    R_j, t_j = jpg.optimize_pose_graph(g_j, jnp.asarray(R0.numpy()), jnp.asarray(t0.numpy()),
                                       num_iters=15)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=GN_ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=GN_ATOL)
    truth = _t(t_abs)
    assert tpg.absolute_trajectory_error(t_t, truth, align=False) < \
        tpg.absolute_trajectory_error(t0, truth, align=False)


def test_optimize_pose_graph_perfect_graph_stays_put():
    """Exact measurements: every edge residual has theta = 0, where log_so3's
    arccos derivative is infinite. Forward mode selects the finite branch,
    so the poses stay finite and put, as in JAX."""
    rng = np.random.default_rng(3)
    R_abs, t_abs, R_rel, t_rel = _trajectory(6, rng)
    g = tpg.build_graph(_t(R_rel), _t(t_rel))
    R_t, t_t = tpg.optimize_pose_graph(g, _t(R_abs), _t(t_abs), num_iters=5)
    assert torch.isfinite(R_t).all() and torch.isfinite(t_t).all()
    R_j, t_j = jpg.optimize_pose_graph(jpg.build_graph(jnp.asarray(R_rel, jnp.float32),
                                                       jnp.asarray(t_rel, jnp.float32)),
                                       jnp.asarray(R_abs, jnp.float32),
                                       jnp.asarray(t_abs, jnp.float32), num_iters=5)
    np.testing.assert_allclose(R_t.numpy(), np.asarray(R_j), atol=GN_ATOL)
    np.testing.assert_allclose(t_t.numpy(), np.asarray(t_j), atol=GN_ATOL)
    np.testing.assert_allclose(R_t.numpy(), R_abs, atol=1e-3)
    np.testing.assert_allclose(t_t.numpy(), t_abs, atol=1e-2)


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


def test_sharded_paths_wait_for_m11():
    """The edge-sharded pose graph on a 1 x 1 mesh (one data rank: the whole
    graph, a sum over one rank) is the dense solve, bit for bit, on the
    noisy loop graph."""
    _, _, R_rel, t_rel, extra = _noisy_loop_graph()
    g = tpg.build_graph(_t(R_rel), _t(t_rel), extra_edges=extra)
    R0, t0 = tpg.chain_poses(_t(R_rel), _t(t_rel))
    want = tpg.optimize_pose_graph(g, R0, t0, num_iters=8)
    with _world_of_one() as mesh:
        got = tpg.optimize_pose_graph_sharded(g, R0, t0, mesh, num_iters=8)
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def _ba_scene(rng, F=6, L=40, obs_noise=0.005):
    """tests/test_landmark_ba.py's scene and perturbation."""
    R_abs, t_abs = [np.eye(3)], [np.zeros(3)]
    for _ in range(F - 1):
        R_abs.append(R_abs[-1] @ _exp(rng.uniform(-0.08, 0.08, 3)))
        t_abs.append(t_abs[-1] + rng.uniform(-0.5, 0.5, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    lms = rng.uniform(-5, 5, (L, 3))
    frame = np.repeat(np.arange(F), L).astype(np.int32)
    lm = np.tile(np.arange(L), F).astype(np.int32)
    xyz = np.einsum("oba,ob->oa", R_abs[frame], lms[lm] - t_abs[frame]) + \
        rng.normal(0, obs_noise, (F * L, 3))
    dw = rng.normal(0, 0.05, (F, 3))
    dw[0] = 0.0
    dt = rng.normal(0, 0.15, (F, 3))
    dt[0] = 0.0
    R0 = np.einsum("fab,fbc->fac", R_abs,
                   np.asarray(jpg.exp_so3(jnp.asarray(dw, jnp.float32)))).astype(np.float32)
    t0 = (t_abs + dt).astype(np.float32)
    lm0 = (lms + rng.normal(0, 0.1, lms.shape)).astype(np.float32)
    R_rel = np.stack([R_abs[i + 1].T @ R_abs[i] for i in range(F - 1)]).astype(np.float32)
    t_rel = np.stack([R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1])
                      for i in range(F - 1)]).astype(np.float32)
    return (frame, lm, xyz.astype(np.float32)), R0, t0, lm0, (R_rel, t_rel), (R_abs, t_abs, lms)


@pytest.mark.parametrize("with_graph", [False, True])
def test_optimize_landmark_ba_matches_jax(with_graph):
    """Schur-complement bundle adjustment (6 frames, 40 landmarks, dense
    visibility), with and without pose-graph edges: the same poses and
    landmarks as JAX within GN_ATOL after 6 steps, and near the truth."""
    (frame, lm, xyz), R0, t0, lm0, (R_rel, t_rel), (R_abs, t_abs, lms) = \
        _ba_scene(np.random.default_rng(2))
    w = np.ones(len(frame), np.float32)
    obs_t = tpg.LandmarkObs(torch.from_numpy(frame).long(), torch.from_numpy(lm).long(),
                            _t(xyz), _t(w))
    obs_j = jpg.LandmarkObs(jnp.asarray(frame), jnp.asarray(lm), jnp.asarray(xyz), jnp.asarray(w))
    g_t = tpg.build_graph(_t(R_rel), _t(t_rel)) if with_graph else None
    g_j = jpg.build_graph(jnp.asarray(R_rel), jnp.asarray(t_rel)) if with_graph else None
    got = tpg.optimize_landmark_ba(g_t, _t(R0), _t(t0), _t(lm0), obs_t, num_iters=6)
    want = jpg.optimize_landmark_ba(g_j, jnp.asarray(R0), jnp.asarray(t0), jnp.asarray(lm0),
                                    obs_j, num_iters=6)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=GN_ATOL)
    np.testing.assert_allclose(got[1].numpy(), t_abs, atol=0.02)
    np.testing.assert_allclose(got[2].numpy(), lms, atol=0.05)
    # the observations on a 1 x 1 mesh: the same solve
    with _world_of_one() as mesh:
        sharded = tpg.optimize_landmark_ba(g_t, _t(R0), _t(t0), _t(lm0), obs_t, mesh=mesh,
                                           num_iters=6)
    for a, b in zip(sharded, got):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


def test_trajectory_metrics_match_jax():
    rng = np.random.default_rng(4)
    R_a, t_a, _, _ = _trajectory(9, rng)
    R_b = np.stack([R @ _exp(rng.normal(0, 0.02, 3)) for R in R_a])
    t_b = t_a @ _exp([0.1, -0.2, 0.3]).T + np.array([5.0, -3.0, 2.0]) + rng.normal(0, 0.05, t_a.shape)
    for align in (True, False):
        got = tpg.absolute_trajectory_error(_t(t_b), _t(t_a), align=align)
        want = jpg.absolute_trajectory_error(jnp.asarray(t_b, jnp.float32),
                                             jnp.asarray(t_a, jnp.float32), align=align)
        np.testing.assert_allclose(float(got), float(want), atol=METRIC_ATOL)
    ang_t, dt_t = tpg.relative_pose_errors(_t(R_b), _t(t_b), _t(R_a), _t(t_a))
    ang_j, dt_j = jpg.relative_pose_errors(*(jnp.asarray(a, jnp.float32)
                                            for a in (R_b, t_b, R_a, t_a)))
    # degrees of ~1: arccos in float32 near 1 limits both to ~1e-3 deg
    np.testing.assert_allclose(ang_t.numpy(), np.asarray(ang_j), atol=2e-3)
    np.testing.assert_allclose(dt_t.numpy(), np.asarray(dt_j), atol=METRIC_ATOL)


# --- register_sequence and run_odometry ------------------------------------------


class _FakeRegistrar:
    """tests/test_odometry.py's fake: the exact pose when the init lies
    within `reach` of it (the candidate grid's reach), identity otherwise;
    in either package's arrays."""

    def __init__(self, true_poses, reach, torch_out):
        self.true_poses, self.reach, self.torch_out = true_poses, reach, torch_out
        self.calls = 0
        self.device = torch.device("cpu")

    def __call__(self, src, tgt, R_init=None, t_init=None):
        R_true, t_true = self.true_poses[self.calls]
        self.calls += 1
        R0 = np.eye(3, dtype=np.float32) if R_init is None else np.asarray(R_init)[0]
        t0 = np.zeros(3, dtype=np.float32) if t_init is None else np.asarray(t_init)[0]
        ok = np.linalg.norm(t_true - t0) + np.linalg.norm(R_true - R0) <= self.reach
        R = R_true if ok else np.eye(3, dtype=np.float32)
        t = t_true if ok else np.zeros(3, dtype=np.float32)
        wrap = torch.from_numpy if self.torch_out else jnp.asarray
        return SimpleNamespace(R=wrap(R[None]), t=wrap(t[None]))

    def stream(self, pairs, depth=4):
        for pair in pairs:
            yield self(*pair)


@pytest.mark.parametrize("warm_start", [True, False])
def test_register_sequence_matches_jax(warm_start):
    """The accelerating sequence (per-frame translation 0.5 ... 1.7 along x,
    reach 1.2): warm start threads each solved pose into the next call and
    recovers every pose; cold starts fail past the reach. Both packages
    give the same poses, the cold one through stream (padded batches are
    run_odometry's test: the fake answers one pose a call)."""
    poses = [(np.eye(3, dtype=np.float32), np.array([0.5 + 0.2 * i, 0, 0], np.float32))
             for i in range(7)]
    scans = np.zeros((8, 16, 3), np.float32)
    kw = dict(warm_start=warm_start)
    R_t, t_t = todo.register_sequence(_FakeRegistrar(poses, 1.2, True), scans, **kw)
    R_j, t_j = jodo.register_sequence(_FakeRegistrar(poses, 1.2, False), scans, **kw)
    np.testing.assert_array_equal(R_t, R_j)
    np.testing.assert_array_equal(t_t, t_j)
    t_true = np.stack([p[1] for p in poses])
    err = np.linalg.norm(t_t - t_true, axis=-1)
    assert (err < 1e-6).all() if warm_start else (err > 0.5).any()


ODO_N = 128   # where the JAX CPU static band covers the slab


@pytest.fixture(scope="module")
def tiny_sequence():
    """DeepVCPConfig.tiny (f32 selection) with flax-initialised weights, and
    a 4-frame sequence of one 1.5 m lidar-like scene moving 0.05 m and 1
    deg a frame, written as KITTI files."""
    cfg = dataclasses.replace(DeepVCPConfig.tiny(ODO_N, use_normal=False), knn_select_dtype=None)
    cloud = lidar_like_cloud(np.random.default_rng(5), ODO_N, max_range=1.5).astype(np.float32)
    R_step = np.asarray(jpg.exp_so3(jnp.asarray([[0.0, 0.0, np.radians(1.0)]], jnp.float32)))[0]
    R_abs, t_abs = [np.eye(3, dtype=np.float32)], [np.zeros(3, np.float32)]
    for i in range(3):
        R_abs.append(R_step @ R_abs[-1])
        t_abs.append(R_step @ t_abs[-1] + np.array([0.05, 0.01 * i, 0.0], np.float32))
    scans = np.stack([cloud @ R.T + t for R, t in zip(R_abs, t_abs)]).astype(np.float32)
    # KITTI's convention: the pose of frame i maps it into frame 0
    gt = (np.stack([R.T for R in R_abs]), np.stack([-R.T @ t for R, t in zip(R_abs, t_abs)]))
    variables = jax.device_get(jax.jit(JDeepVCP(cfg=cfg).init)(
        jax.random.key(0), scans[:1], scans[1:2], np.eye(3, dtype=np.float32)[None],
        np.zeros((1, 3), np.float32)))
    return cfg, variables, scans, gt


@pytest.mark.parametrize("warm_start", [True, False])
def test_run_odometry_matches_jax(tiny_sequence, warm_start):
    """A tiny real registrar (refine_iters 2) over the 4-frame sequence,
    warm and cold (batches of 2, the last padded): relative poses, chained
    and optimised trajectories within GN_ATOL of JAX's, and the metrics
    against the sequence's true poses within METRIC_ATOL."""
    cfg, variables, scans, gt = tiny_sequence
    kw = dict(refine_iters=2)
    reg_t = Registrar(cfg, variables, "cpu", **kw)
    reg_j = JRegistrar(cfg, variables, **kw)
    run = dict(gt_poses=gt, gn_iters=5, batch_size=2, warm_start=warm_start)
    got = todo.run_odometry(reg_t, scans, **run)
    want = jodo.run_odometry(reg_j, scans, **run)
    for key in ("R_rel", "t_rel", "R_abs", "t_abs", "R_opt", "t_opt"):
        assert got[key].shape == want[key].shape, key
        np.testing.assert_allclose(got[key], want[key], atol=GN_ATOL, err_msg=key)
    for key in ("ate_rmse", "rpe_trans_mean"):
        np.testing.assert_allclose(got[key], want[key], atol=METRIC_ATOL, err_msg=key)
    np.testing.assert_allclose(got["rpe_rot_deg_mean"], want["rpe_rot_deg_mean"], atol=2e-3)


def _write_kitti(root, scans, poses=None):
    vdir = os.path.join(root, "sequences", "00", "velodyne")
    os.makedirs(vdir)
    for i, scan in enumerate(scans):
        xyzr = np.concatenate([scan, np.zeros((len(scan), 1), np.float32)], axis=-1)
        xyzr.astype(np.float32).tofile(os.path.join(vdir, f"{i:06d}.bin"))
    if poses is not None:
        os.makedirs(os.path.join(root, "poses"))
        R, t = poses
        rows = np.concatenate([R, t[:, :, None]], axis=-1).reshape(len(R), 12)
        np.savetxt(os.path.join(root, "poses", "00.txt"), rows)


def test_sequence_loaders_match_jax(tmp_path, tiny_sequence):
    _, _, scans, gt = tiny_sequence
    _write_kitti(str(tmp_path), scans, gt)
    for n, seed in ((ODO_N, 0), (100, 3), (200, 1)):
        got = todo.load_sequence_scans(str(tmp_path), "00", n, max_frames=3, seed=seed)
        want = jodo.load_sequence_scans(str(tmp_path), "00", n, max_frames=3, seed=seed)
        assert got.dtype == want.dtype == np.float32 and got.shape == (3, n, 3)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(todo.load_sequence_scans(str(tmp_path), "00", ODO_N), scans)
    for a, b in zip(todo.load_kitti_poses(str(tmp_path / "poses" / "00.txt")),
                    jodo.load_kitti_poses(str(tmp_path / "poses" / "00.txt"))):
        np.testing.assert_array_equal(a, b)


def test_odometry_cli_on_a_written_sequence(tmp_path, tiny_sequence, capsys):
    """python -m deepvcp_tpu_torch.odometry --device cpu --tiny on a written
    4-frame sequence with its poses: the JSON line and the .npz keys of the
    JAX CLI; then with a checkpoint saved by the port's Trainer, loaded
    strictly (the same weights give the same trajectory); a wrong root
    exits before any torch work."""
    from deepvcp_tpu_torch.config import DeepVCPConfig as TConfig, TrainConfig
    from deepvcp_tpu_torch.odometry.__main__ import main
    from deepvcp_tpu_torch.train import Trainer

    _, _, scans, gt = tiny_sequence
    root = str(tmp_path / "kitti")
    _write_kitti(root, scans, gt)
    args = ["--device", "cpu", "--root", root, "--sequence", "00", "--tiny",
            "--num-points", str(ODO_N)]

    def run(extra):
        out = str(tmp_path / f"traj{len(extra)}.npz")
        main(args + ["--out", out] + extra)
        line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("{")][-1]
        return json.loads(line), dict(np.load(out))

    metrics, traj = run([])
    assert metrics["frames"] == 4 and np.isfinite(metrics["ate_rmse"])
    assert set(metrics) == {"frames", "ate_rmse", "rpe_rot_deg_mean", "rpe_trans_mean"}
    assert sorted(traj) == sorted(["R_rel", "t_rel", "R_abs", "t_abs", "R_opt", "t_opt"])
    assert traj["t_opt"].shape == (4, 3)

    trainer = Trainer(TConfig.tiny(ODO_N, use_normal=False),
                      TrainConfig(checkpoint_dir=str(tmp_path / "ckpt"),
                                  metrics_path=str(tmp_path / "m.jsonl")), device="cpu")
    trainer.setup()
    path = trainer.save_checkpoint("final")
    m2, t2 = run(["--checkpoint", path, "--no-optimize", "--max-frames", "3"])
    assert m2["frames"] == 3 and sorted(t2) == sorted(["R_rel", "t_rel", "R_abs", "t_abs"])
    reg = Registrar(TConfig.tiny(ODO_N, use_normal=False), trainer.model.state_dict(), "cpu")
    want = todo.run_odometry(reg, scans[:3], optimize=False)
    np.testing.assert_array_equal(t2["t_rel"], want["t_rel"])
    with pytest.raises(SystemExit, match="no velodyne scans"):
        main(["--device", "cpu", "--root", str(tmp_path / "nowhere")])
