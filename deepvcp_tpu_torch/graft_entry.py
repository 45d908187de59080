"""Entry points of the port (counterpart of the repo's
__graft_entry__.py).

entry(device=...) -> (fn, example_args): a forward step of the flagship
DeepVCP model (random weights, modest N) on the device.

dryrun_multichip(n_ranks, device=...): one full train step over an
n-rank ("data", "point") mesh (data parallel over frame pairs, the
candidate KNN as the ring over the point group), built with make_mesh and
make_train_step(mesh=...), each rank a process of parallel.launch: on the
CPU over gloo, on "cuda" over NCCL with one card a rank (rank r on card r),
so at most as many ranks as visible cards.

    python -m deepvcp_tpu_torch.graft_entry [--cpu] [--ranks N]

--ranks defaults to 8 on the CPU (the JAX dryrun's 8 devices) and to the
visible cards on "cuda"; more ranks than cards is refused with the reason.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch


def _example_batch(cfg, batch: int, seed: int = 0):
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator

    ds = SyntheticDataset(num_clouds=batch, num_points=cfg.num_points,
                          use_normal=cfg.use_normal, extent=5.0, seed=seed)
    return next(batch_iterator(ds, batch, epoch=0, seed=seed))


def entry(*, device):
    """A forward step on the flagship model at N = 256: (fn, (model, src,
    tgt, R, t)) with fn(model, src, tgt, R, t) -> (keypoints, vcp)."""
    from deepvcp_tpu_torch.config import DeepVCPConfig
    from deepvcp_tpu_torch.models import DeepVCP

    cfg = DeepVCPConfig.tiny(num_points=256, use_normal=False)
    torch.manual_seed(0)
    model = DeepVCP(cfg).to(device).eval()
    src, tgt, R, t = (torch.from_numpy(a).to(device) for a in _example_batch(cfg, batch=1))

    @torch.no_grad()
    def fn(model, src, tgt, R, t):
        kp, vcp, _ = model(src, tgt, R, t)
        return kp, vcp

    return fn, (model, src, tgt, R, t)


def _dryrun_rank(num_points: int, device: str) -> float:
    """One rank of dryrun_multichip: its train step's loss. On "cuda" rank r
    must be on card r (RuntimeError otherwise)."""
    import torch.distributed as dist

    from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
    from deepvcp_tpu_torch.models import DeepVCP
    from deepvcp_tpu_torch.parallel import make_mesh, shard_batch
    from deepvcp_tpu_torch.parallel.mesh import DATA_AXIS, axis_size, rank_card
    from deepvcp_tpu_torch.train import create_train_state, make_train_step

    n, rank = dist.get_world_size(), dist.get_rank()
    card = rank_card(torch.device(device).type)
    if card.type == "cuda" and card.index != rank:
        raise RuntimeError(f"dryrun_multichip: rank {rank} is on {card}, not cuda:{rank}")
    # e.g. 8 ranks -> 4-way data parallel x 2-way point groups
    mesh = make_mesh(point=2 if n % 2 == 0 else 1, device=device)
    cfg = DeepVCPConfig.tiny(num_points=num_points, use_normal=False)
    tcfg = TrainConfig(batch_size=axis_size(mesh, DATA_AXIS), metrics_path=None)
    torch.manual_seed(tcfg.seed)
    model = DeepVCP(cfg, knn_mesh=mesh).to(device)
    state, schedule = create_train_state(model, tcfg)
    step = make_train_step(model, schedule, tcfg, mesh=mesh)
    state, metrics = step(state, *shard_batch(mesh, _example_batch(cfg, tcfg.batch_size)))
    loss = float(metrics["loss"])
    assert np.isfinite(loss), loss
    assert state.step == 1
    print(f"dryrun_multichip OK: rank {rank} on {card}, "
          f"mesh={dict(zip(mesh.mesh_dim_names, mesh.shape))} loss={loss:.4f} "
          f"rre={float(metrics['rre_deg']):.3f}deg", flush=True)
    return loss


def dryrun_multichip(n_ranks: int, num_points: int = 1024, *, device: str,
                     timeout_s: float = 600.0) -> float:
    """The train step over an n-rank mesh at N = num_points, the ranks
    spawned here (gloo on the CPU; NCCL on "cuda", rank r bound to card r
    by initialize_multihost). Returns the loss, which every rank must agree
    on. More ranks than visible cards on "cuda" raises RuntimeError before
    any rank starts."""
    from deepvcp_tpu_torch.parallel.launch import run_ranks

    if torch.device(device).type == "cuda" and not 1 <= n_ranks <= torch.cuda.device_count():
        raise RuntimeError(f"dryrun_multichip: {n_ranks} ranks need {n_ranks} cards (NCCL takes "
                           f"one card a rank), {torch.cuda.device_count()} visible")
    losses = run_ranks("deepvcp_tpu_torch.graft_entry:_dryrun_rank", n_ranks,
                       kwargs={"num_points": num_points, "device": device}, device=device,
                       timeout_s=timeout_s, echo=True)
    assert len(set(losses)) == 1, losses
    return losses[0]


if __name__ == "__main__":
    p = argparse.ArgumentParser()
    p.add_argument("--cpu", action="store_true", help="run on the CPU, not the card")
    p.add_argument("--ranks", type=int, default=None,
                   help="ranks of the mesh (default: 8 on the CPU, the visible cards on cuda)")
    args = p.parse_args()
    device = "cpu" if args.cpu else "cuda"
    ranks = args.ranks or (8 if args.cpu else torch.cuda.device_count())
    try:
        dryrun_multichip(ranks, device=device)
    except RuntimeError as e:
        p.exit(1, f"{e}\n")
    fn, example = entry(device=device)
    print("entry OK:", [tuple(o.shape) for o in fn(*example)])
