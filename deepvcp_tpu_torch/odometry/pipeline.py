"""KITTI sequence odometry (port of deepvcp_tpu/odometry/pipeline.py):
register consecutive frames with a trained model, chain the relative poses
into a trajectory, optimise the pose graph, and score it against ground
truth where there is one.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from deepvcp_tpu_torch.data.datasets import read_velodyne_bin
from deepvcp_tpu_torch.data.transforms import resample
from deepvcp_tpu_torch.odometry.pose_graph import (
    absolute_trajectory_error,
    build_graph,
    chain_poses,
    optimize_pose_graph,
    relative_pose_errors,
)


def load_kitti_poses(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """A KITTI odometry pose file: each row a 3x4 [R|t] mapping frame i
    into frame 0. Returns (R [F, 3, 3], t [F, 3])."""
    raw = np.loadtxt(path).reshape(-1, 3, 4)
    return raw[:, :, :3], raw[:, :, 3]


def load_sequence_scans(root: str, sequence: str, num_points: int,
                        max_frames: Optional[int] = None, seed: int = 0) -> np.ndarray:
    """[F, num_points, 3] float32 velodyne scans of one sequence
    (root/sequences/<sequence>/velodyne/*.bin in name order), each resampled
    to num_points with one generator seeded by `seed`."""
    vdir = os.path.join(root, "sequences", sequence, "velodyne")
    files = sorted(os.listdir(vdir))[:max_frames]
    rng = np.random.default_rng(seed)
    scans = [resample(read_velodyne_bin(os.path.join(vdir, f))[:, :3], num_points, rng)
             .astype(np.float32) for f in files]
    return np.stack(scans)


def register_sequence(registrar, scans: np.ndarray, batch_size: int = 1,
                      warm_start: bool = True, stream_depth: int = 4
                      ) -> Tuple[np.ndarray, np.ndarray]:
    """Register consecutive frames (src = i, tgt = i + 1) with a Registrar,
    CascadeRegistrar or RoutedRegistrar; scans go to its device.

    With `warm_start`, pair i + 1 starts from pair i's solved pose (the
    constant-velocity prior, which leaves only the per-frame acceleration
    to the candidate grid's reach); the prior stays on the device, and the
    pairs run one at a time (batch_size is ignored). Without it, pairs start
    from the identity in batches of `batch_size` (the last padded to one
    shape by repeating its last pair) through registrar.stream at
    `stream_depth`.

    Returns (R_rel [F - 1, 3, 3], t_rel [F - 1, 3]) numpy float32 with
    x_{i+1} ~= R_rel[i] x_i + t_rel[i]."""
    dev = registrar.device
    F = scans.shape[0]
    if warm_start:
        R_prev = torch.eye(3, dtype=torch.float32, device=dev)[None]
        t_prev = torch.zeros(1, 3, dtype=torch.float32, device=dev)
        R_out, t_out = [], []
        for i in range(F - 1):
            src = torch.from_numpy(scans[i:i + 1]).to(dev)
            tgt = torch.from_numpy(scans[i + 1:i + 2]).to(dev)
            out = registrar(src, tgt, R_init=R_prev, t_init=t_prev)
            R_prev, t_prev = out.R, out.t
            R_out.append(R_prev)
            t_out.append(t_prev)
        return torch.cat(R_out).cpu().numpy(), torch.cat(t_out).cpu().numpy()

    def batches():
        for start in range(0, F - 1, batch_size):
            idx = np.arange(start, min(start + batch_size, F - 1))
            src, tgt = scans[idx], scans[idx + 1]
            pad = batch_size - len(idx)
            if pad:
                src = np.concatenate([src, src[-1:].repeat(pad, axis=0)])
                tgt = np.concatenate([tgt, tgt[-1:].repeat(pad, axis=0)])
            yield torch.from_numpy(src).to(dev), torch.from_numpy(tgt).to(dev)

    R_out, t_out = [], []
    n_left = F - 1
    for out in registrar.stream(batches(), depth=stream_depth):
        take = min(batch_size, n_left)
        n_left -= take
        R_out.append(out.R[:take].cpu().numpy())
        t_out.append(out.t[:take].cpu().numpy())
    return np.concatenate(R_out), np.concatenate(t_out)


def run_odometry(registrar, scans: np.ndarray,
                 gt_poses: Optional[Tuple[np.ndarray, np.ndarray]] = None,
                 optimize: bool = True, gn_iters: int = 20, batch_size: int = 1,
                 warm_start: bool = True) -> dict:
    """A whole odometry run on the registrar's device: register_sequence,
    chain_poses, and with `optimize` the sequential pose graph refined by
    `gn_iters` Gauss-Newton steps; with ground-truth absolute poses
    (R [F, 3, 3], t [F, 3]), the ATE (RMSE after alignment) and the mean
    RPE of the optimised trajectory (else the chained one). Returns a dict
    of numpy arrays (R_rel, t_rel, R_abs, t_abs, R_opt, t_opt) and floats
    (ate_rmse, rpe_rot_deg_mean, rpe_trans_mean)."""
    dev = registrar.device
    R_rel, t_rel = register_sequence(registrar, scans, batch_size, warm_start=warm_start)
    R_rel_d, t_rel_d = torch.from_numpy(R_rel).to(dev), torch.from_numpy(t_rel).to(dev)
    R_abs, t_abs = chain_poses(R_rel_d, t_rel_d)
    result = {"R_rel": R_rel, "t_rel": t_rel,
              "R_abs": R_abs.cpu().numpy(), "t_abs": t_abs.cpu().numpy()}
    R_est, t_est = R_abs, t_abs
    if optimize:
        graph = build_graph(R_rel_d, t_rel_d)
        R_est, t_est = optimize_pose_graph(graph, R_abs, t_abs, num_iters=gn_iters)
        result["R_opt"] = R_est.cpu().numpy()
        result["t_opt"] = t_est.cpu().numpy()
    if gt_poses is not None:
        F = scans.shape[0]
        R_gt, t_gt = (torch.as_tensor(np.asarray(a[:F]), dtype=torch.float32, device=dev)
                      for a in gt_poses)
        result["ate_rmse"] = float(absolute_trajectory_error(t_est, t_gt))
        ang, dt = relative_pose_errors(R_est, t_est, R_gt, t_gt)
        result["rpe_rot_deg_mean"] = float(torch.mean(ang))
        result["rpe_trans_mean"] = float(torch.mean(dt))
    return result
