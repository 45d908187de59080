"""Inference walkthrough: register two point clouds with the shipped
checkpoints (counterpart of examples/register_pair.py).

    python -m deepvcp_tpu_torch.examples.register_pair [--cpu] [--num-points 2048]
                                                       [--full-so3] [--kitti]

Demonstrates, by flag:
  1. one-call registration with a named pretrained model (modelnet-fine),
  2. unrestricted SO(3) (--full-so3): so3_global_init (FPS on kernel K3)
     feeding the modelnet-cascade,
  3. the KITTI-scale cascade on lidar-like clouds (--kitti).
Runs on the card unless given --cpu.
"""

from __future__ import annotations

import argparse


def main(argv=None):
    """Runs the walkthrough and returns {"rre": [B], "rte": [B], "out":
    RegistrationOutput, "init_rre": [B] or None} (numpy errors)."""
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true")
    p.add_argument("--num-points", type=int, default=2048)
    p.add_argument("--full-so3", action="store_true",
                   help="unrestricted rotations + the global initializer")
    p.add_argument("--kitti", action="store_true",
                   help="use the KITTI-scale cascade on lidar-like clouds")
    args = p.parse_args(argv)

    import numpy as np
    import torch

    from deepvcp_tpu_torch import pretrained
    from deepvcp_tpu_torch.data import (
        LidarLikeDataset, SyntheticDataset, batch_iterator, rotation_geodesic_deg)

    device = torch.device("cpu" if args.cpu else "cuda")
    N = args.num_points
    if args.kitti:
        ds = LidarLikeDataset(num_clouds=2, num_points=N, max_range=25.0, seed=7,
                              max_rotation_deg=5.0, max_translation=0.5)
        reg = pretrained.cascade("kitti-cascade", device=device, num_points=N)
    elif args.full_so3:
        ds = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0, seed=7,
                              noise_std=0.01)  # any rotation
        reg = pretrained.cascade("modelnet-cascade", device=device, num_points=N)
    else:
        ds = SyntheticDataset(num_clouds=2, num_points=N, extent=1.0, seed=7,
                              max_rotation_deg=10.0, max_translation=0.5)
        reg = pretrained.registrar("modelnet-fine", device=device, num_points=N)

    src, tgt, R_gt, t_gt = (torch.from_numpy(a).to(reg.device)
                            for a in next(batch_iterator(ds, 2, epoch=0, seed=0)))

    R_init = t_init = init_rre = None
    if args.full_so3:
        from deepvcp_tpu_torch.initializer import so3_global_init

        init = so3_global_init(src, tgt)
        R_init, t_init = init.R, init.t
        init_rre = rotation_geodesic_deg(init.R, R_gt).cpu().numpy()
        print("global init RRE:", init_rre)

    out = reg(src, tgt, R_init, t_init)

    rre = rotation_geodesic_deg(out.R, R_gt).cpu().numpy()
    rte = torch.linalg.norm(out.t - t_gt, dim=-1).cpu().numpy()
    print(f"RRE (deg): {rre}")
    print(f"RTE:       {rte}")
    print(f"guard scores (col 0 = init): {out.scores.cpu().numpy()}")
    print(f"keypoints {tuple(out.keypoints.shape)}, vcps {tuple(out.vcps.shape)}")
    return {"rre": np.asarray(rre), "rte": np.asarray(rte), "out": out, "init_rre": init_rre}


if __name__ == "__main__":
    main()
