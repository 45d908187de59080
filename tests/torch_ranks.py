"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_ring_knn.py, test_torch_distributed_ba.py, test_torch_tooling.py).

Each runs in a spawned process of deepvcp_tpu_torch.parallel.launch.run_ranks,
inside an initialised gloo process group on the CPU, and returns numpy
arrays and floats. This module imports no jax (a spawned rank does not run
tests/conftest.py): the tests compute their JAX references in the parent.
"""

from __future__ import annotations

import torch

from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.parallel import make_mesh, shard_batch


def _numpy(d):
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


def train_step(shape, cfg: DeepVCPConfig, tcfg: TrainConfig, state, batch, ring=False,
               local=None):
    """One sharded train step on a (data, point) mesh from `state` (model
    state dict as numpy) on the global `batch`; with `local` ("host-local"
    loading), the batch is instead this rank's stride of `local` = (dataset
    kwargs, per-host batch size), read through batch_iterator. Returns the
    metrics, the parameters and running statistics after the step."""
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size
    from deepvcp_tpu_torch.train import create_train_state, make_train_step

    mesh = make_mesh(*shape, device="cpu")
    model = DeepVCP(cfg, knn_mesh=mesh if ring else None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    ts, schedule = create_train_state(model, tcfg)
    step = make_train_step(model, schedule, tcfg, mesh=mesh)
    if local is None:
        args = shard_batch(mesh, batch)
    else:
        ds_kwargs, per_host = local
        ds = SyntheticDataset(**ds_kwargs)
        args = shard_batch(mesh, next(batch_iterator(
            ds, per_host, epoch=0, seed=0, host_id=axis_index(mesh, DATA_AXIS),
            num_hosts=axis_size(mesh, DATA_AXIS))), local=True)
    ts, metrics = step(ts, *args)
    out = {k: float(v) for k, v in metrics.items()}
    print(f"rank {torch.distributed.get_rank()}: loss {out['loss']:.8f}", flush=True)
    return {"metrics": out, "params": _numpy(dict(model.named_parameters())),
            "stats": _numpy({n: b for n, b in model.named_buffers() if "running" in n}),
            "step": ts.step}


def ring_knn(shape, ref, query, k, batch_axis=None):
    from deepvcp_tpu_torch.ops.distributed import ring_knn as ring

    mesh = make_mesh(*shape, device="cpu")
    d, i = ring(mesh, torch.from_numpy(ref), torch.from_numpy(query), k, batch_axis=batch_axis)
    return d.numpy(), i.numpy()


def ring_forward(shape, cfg: DeepVCPConfig, state, batch):
    """The model's eval forward with knn_mesh set: (keypoints, vcp, whether
    the ring's gate passed)."""
    mesh = make_mesh(*shape, device="cpu")
    model = DeepVCP(cfg, knn_mesh=mesh)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    model.eval()
    src, tgt, R, t = (torch.from_numpy(a) for a in batch)
    with torch.no_grad():
        kp, vcp, _ = model(src, tgt, R, t)
    K, C = model.cfg.num_keypoints, model.cfg.num_candidates
    return kp.numpy(), vcp.numpy(), model._use_ring(src.shape[1], K * C, model.cfg.num_neighbors)


def pose_graph(shape, graph, R0, t0, num_iters):
    from deepvcp_tpu_torch.odometry import PoseGraph, optimize_pose_graph_sharded

    mesh = make_mesh(*shape, device="cpu")
    g = PoseGraph(*(torch.from_numpy(a) for a in graph))
    R, t = optimize_pose_graph_sharded(g, torch.from_numpy(R0), torch.from_numpy(t0), mesh,
                                       num_iters=num_iters)
    return R.numpy(), t.numpy()


def landmark_ba(shape, graph, R0, t0, lm0, obs, num_iters):
    from deepvcp_tpu_torch.odometry import LandmarkObs, PoseGraph, optimize_landmark_ba

    mesh = make_mesh(*shape, device="cpu")
    g = None if graph is None else PoseGraph(*(torch.from_numpy(a) for a in graph))
    out = optimize_landmark_ba(g, torch.from_numpy(R0), torch.from_numpy(t0),
                               torch.from_numpy(lm0),
                               LandmarkObs(*(torch.from_numpy(a) for a in obs)), mesh=mesh,
                               num_iters=num_iters)
    return tuple(a.numpy() for a in out)


def run_cases(cases):
    """Several bodies in one run of ranks: cases {name: (body, kwargs)} ->
    {name: the body's result}, in order, so that the tests of a file share
    one start of the ranks."""
    return {name: globals()[body](**kwargs) for name, (body, kwargs) in cases.items()}

