"""Odometry CLI of the port (the flags of deepvcp_tpu/odometry/__main__.py,
plus a required --device):

    python -m deepvcp_tpu_torch.odometry --device cuda --root /data/kitti \
        --sequence 00 --checkpoint checkpoints/final --max-frames 200

--checkpoint takes a checkpoint the port's train.Trainer saved; without
one the model is randomly initialised (a smoke run). Writes the trajectory
to --out (.npz) and prints one JSON line of metrics.
"""

import argparse
import json
import os
import sys

import numpy as np


def main(argv=None):
    p = argparse.ArgumentParser(description="KITTI sequence odometry (PyTorch port)")
    p.add_argument("--device", required=True,
                   help="torch device to run on, e.g. cuda, cuda:1 or cpu")
    p.add_argument("--root", required=True, help="KITTI odometry root")
    p.add_argument("--sequence", default="00")
    p.add_argument("--checkpoint", default=None,
                   help="checkpoint saved by the port's Trainer (omit for a random-init "
                        "smoke run)")
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--max-frames", type=int, default=None)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--no-optimize", action="store_true")
    p.add_argument("--tiny", action="store_true")
    p.add_argument("--out", default="trajectory.npz")
    args = p.parse_args(argv)

    seq_dir = os.path.join(args.root, "sequences", args.sequence, "velodyne")
    if not os.path.isdir(seq_dir):
        # before any torch work, so that a wrong path is reported plainly
        sys.exit(f"error: no velodyne scans at {seq_dir}")

    import torch

    from deepvcp_tpu_torch.config import DeepVCPConfig
    from deepvcp_tpu_torch.models import DeepVCP
    from deepvcp_tpu_torch.odometry import load_kitti_poses, load_sequence_scans, run_odometry
    from deepvcp_tpu_torch.registration import Registrar

    cfg = (DeepVCPConfig.tiny(args.num_points, use_normal=False) if args.tiny
           else DeepVCPConfig(num_points=args.num_points, use_normal=False))
    scans = load_sequence_scans(args.root, args.sequence, cfg.num_points, args.max_frames)
    print(f"loaded {scans.shape[0]} frames of {scans.shape[1]} points")

    if args.checkpoint:
        state = torch.load(os.path.abspath(args.checkpoint), map_location="cpu",
                           weights_only=True)["model"]
    else:
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(0)
            state = DeepVCP(cfg).state_dict()

    gt = None
    pose_file = os.path.join(args.root, "poses", f"{args.sequence}.txt")
    if os.path.exists(pose_file):
        gt = load_kitti_poses(pose_file)

    reg = Registrar(cfg, state, args.device)
    result = run_odometry(reg, scans, gt_poses=gt, optimize=not args.no_optimize,
                          batch_size=args.batch_size)
    np.savez(args.out, **{k: v for k, v in result.items() if isinstance(v, np.ndarray)})
    metrics = {k: v for k, v in result.items() if not isinstance(v, np.ndarray)}
    print(json.dumps({"frames": int(scans.shape[0]), **metrics}))
    print(f"trajectory saved to {args.out}")


if __name__ == "__main__":
    main()
