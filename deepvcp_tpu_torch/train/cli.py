"""Training CLI of the port (the flags of deepvcp_tpu/train/cli.py, plus a
required --device).

    python -m deepvcp_tpu_torch.train --device cuda -d synthetic --recipe residual
    python -m deepvcp_tpu_torch.train --device cpu --tiny -d synthetic --num-points 128 --epochs 1

--dataset modelnet and kitti read their files under --root (data/datasets.py).
With --eval-only, --save-vis DIR registers every test pair with the trained
weights and writes {i}_gt.npy / {i}_pred.npy and vis.pcd to DIR
(utils/vis.py), as the JAX CLI does.
"""

from __future__ import annotations

import argparse
import dataclasses

from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig

def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train DeepVCP (PyTorch port)")
    p.add_argument("--device", required=True,
                   help="torch device to train on, e.g. cuda, cuda:1 or cpu")
    p.add_argument("-d", "--dataset", default="modelnet",
                   choices=["modelnet", "kitti", "synthetic"],
                   help="dataset (modelnet, kitti, or synthetic)")
    p.add_argument("-f", "--full_dataset", default="full",
                   help="train on 'full' or 'partial' dataset")
    p.add_argument("-r", "--retrain_path", type=str, default=None,
                   help="port checkpoint to warm-start from")
    p.add_argument("-m", "--model_path", type=str, default="final_model",
                   help="tag for the final checkpoint")
    p.add_argument("--root", type=str, default=None, help="dataset root dir")
    p.add_argument("--checkpoint-dir", type=str, default="checkpoints")
    p.add_argument("--metrics-path", type=str, default="metrics.jsonl")
    p.add_argument("--epochs", type=int, default=10)
    p.add_argument("--batch-size", type=int, default=1)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--alpha", type=float, default=0.5)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--num-points", type=int, default=10000)
    p.add_argument("--num-keypoints", type=int, default=64)
    p.add_argument("--tiny", action="store_true",
                   help="use the tiny test topology (smoke runs)")
    p.add_argument("--eval-only", action="store_true",
                   help="load --retrain_path and evaluate the test split")
    p.add_argument("--resume", action="store_true",
                   help="resume from the latest checkpoint in --checkpoint-dir")
    p.add_argument("--save-vis", type=str, default=None, metavar="DIR",
                   help="with --eval-only: save {i}_gt.npy/{i}_pred.npy cloud pairs "
                        "+ vis.pcd to DIR")
    p.add_argument("--recipe", default="reference", choices=["reference", "residual"],
                   help="'reference' = GT warm start, rigid-fit-only loss, constant "
                        "lr; 'residual' = jittered warm starts, direct VCP L1 term, "
                        "cosine lr, saliency-weighted solves")
    p.add_argument("--init-rot-jitter-deg", type=float, default=None,
                   help="override the warm-start rotation jitter (residual recipe: 12)")
    p.add_argument("--init-trans-jitter", type=float, default=None,
                   help="override the warm-start translation jitter (residual recipe: 0.5)")
    p.add_argument("--keypoint-selection", default=None, choices=["topk", "salient_fps"],
                   help="keypoint policy (salient_fps is not ported)")
    return p


def configs_from_args(args) -> tuple[DeepVCPConfig, TrainConfig]:
    use_normal = args.dataset == "modelnet"
    if args.tiny:
        model_cfg = DeepVCPConfig.tiny(num_points=args.num_points, use_normal=use_normal)
    else:
        model_cfg = DeepVCPConfig(num_points=args.num_points, use_normal=use_normal,
                                  num_keypoints=args.num_keypoints)
    if args.keypoint_selection is not None:
        model_cfg = dataclasses.replace(model_cfg, keypoint_selection=args.keypoint_selection)
    extra = {}
    if args.recipe == "residual":
        # total_steps for the cosine schedule is filled in by main()
        extra = dict(vcp_loss_weight=1.0, lr_schedule="cosine", warmup_steps=100,
                     use_saliency_weights=True, init_translation="gt",
                     init_rot_jitter_deg=12.0, init_trans_jitter=0.5)
    if args.init_rot_jitter_deg is not None:
        extra["init_rot_jitter_deg"] = args.init_rot_jitter_deg
    if args.init_trans_jitter is not None:
        extra["init_trans_jitter"] = args.init_trans_jitter
    train_cfg = TrainConfig(num_epochs=args.epochs, batch_size=args.batch_size,
                            learning_rate=args.lr, alpha=args.alpha, seed=args.seed,
                            checkpoint_dir=args.checkpoint_dir,
                            metrics_path=args.metrics_path, **extra)
    return model_cfg, train_cfg


def make_dataset(args, model_cfg: DeepVCPConfig, split: str):
    from deepvcp_tpu_torch.data import KITTIDataset, ModelNet40Dataset, SyntheticDataset

    if args.dataset == "modelnet":
        if not args.root:
            raise SystemExit("--root is required for modelnet")
        return ModelNet40Dataset(args.root, split=split,
                                 full_dataset=args.full_dataset == "full",
                                 num_points=model_cfg.num_points,
                                 use_normal=model_cfg.use_normal)
    if args.dataset == "kitti":
        if not args.root:
            raise SystemExit("--root is required for kitti")
        return KITTIDataset(args.root, split=split, num_points=model_cfg.num_points)
    return SyntheticDataset(num_clouds=16 if split == "train" else 4,
                            num_points=model_cfg.num_points, use_normal=model_cfg.use_normal,
                            seed=0 if split == "train" else 1)


def main(argv=None) -> None:
    args = build_parser().parse_args(argv)
    model_cfg, train_cfg = configs_from_args(args)

    from deepvcp_tpu_torch.data import batch_iterator
    from deepvcp_tpu_torch.train.trainer import Trainer

    train_data = make_dataset(args, model_cfg, "train")
    test_data = make_dataset(args, model_cfg, "test")
    print(f"Train dataset size: {len(train_data)}  Test dataset size: {len(test_data)}")

    if train_cfg.lr_schedule == "cosine" and train_cfg.total_steps == 0:
        steps_per_epoch = max(len(train_data) // train_cfg.batch_size, 1)
        train_cfg = dataclasses.replace(train_cfg,
                                        total_steps=train_cfg.num_epochs * steps_per_epoch)

    trainer = Trainer(model_cfg, train_cfg, device=args.device)
    trainer.setup(retrain_path=args.retrain_path)

    def eval_batches(epoch):
        return batch_iterator(test_data, train_cfg.batch_size, epoch=epoch,
                              seed=train_cfg.seed + 1, shuffle=False)

    if args.eval_only:
        print("eval:", trainer.evaluate(eval_batches(0)))
        if args.save_vis:
            save_vis(args.save_vis, model_cfg, trainer, eval_batches(0))
        return

    def train_batches(epoch):
        return batch_iterator(train_data, train_cfg.batch_size, epoch=epoch, seed=train_cfg.seed)

    trainer.fit(train_batches, eval_batches, resume=args.resume)
    path = trainer.save_checkpoint(args.model_path)
    print(f"Finished Training; final checkpoint at {path}")


def save_vis(out_dir: str, model_cfg: DeepVCPConfig, trainer, batches) -> None:
    """Register every pair of `batches` with the trainer's weights (a
    Registrar with its defaults, on the trainer's device) and write each
    target and transformed source as {i}_gt.npy / {i}_pred.npy, and the
    last batch's first pair as vis.pcd (as the JAX CLI does), to out_dir."""
    import os

    import torch

    from deepvcp_tpu_torch.ops import apply_rigid
    from deepvcp_tpu_torch.registration import Registrar
    from deepvcp_tpu_torch.utils.vis import draw, save_cloud_pair

    reg = Registrar(model_cfg, trainer.model.state_dict(), trainer.device)
    i = 0
    for src, tgt, _, _ in batches:
        src_t = torch.from_numpy(src).to(reg.device)
        r = reg(src_t, torch.from_numpy(tgt).to(reg.device))
        pred = apply_rigid(src_t[..., :3], r.R, r.t).cpu().numpy()
        for b in range(src.shape[0]):
            save_cloud_pair(out_dir, i, tgt[b, :, :3], pred[b])
            i += 1
    draw([tgt[0, :, :3], pred[0]], os.path.join(out_dir, "vis.pcd"))
    print(f"vis saved to {out_dir}")


if __name__ == "__main__":
    main()
