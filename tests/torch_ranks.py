"""Rank bodies of the port's multi-process tests (tests/test_torch_parallel.py,
test_torch_ring_knn.py, test_torch_distributed_ba.py, test_torch_tooling.py,
test_torch_point_partition.py, test_torch_point_partition_engines.py).

Each runs in a spawned process of deepvcp_tpu_torch.parallel.launch.run_ranks,
inside an initialised gloo process group on the CPU, and returns numpy
arrays and floats. This module imports no jax (a spawned rank does not run
tests/conftest.py): the tests compute their JAX references in the parent.
"""

from __future__ import annotations

import contextlib

import torch

from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.parallel import make_mesh, shard_batch


def _numpy(d):
    return {k: v.detach().cpu().numpy().copy() for k, v in d.items()}


@contextlib.contextmanager
def _recording_inputs(model, seen):
    """Within the block, record the input shape of each call of the modules
    that run per point or per keypoint into seen {name: [shapes]}: the DFE,
    the CPG and the saliency by forward hooks, each SA stage's first tail
    layer and the FE projection at models.fused_sa.linear (in bf16 it
    multiplies by the layer's weights without calling the module)."""
    from unittest import mock

    from deepvcp_tpu_torch.models import fused_sa, layers

    hooks = [m.register_forward_hook(
        lambda mod, args, out, name=name: seen.setdefault(name, []).append(tuple(args[0].shape)))
        for name, m in {"dfe": model.dfe, "cpg": model.cpg, "wl": model.wl}.items()]
    dense = {model.fe.proj: "proj"}
    dense.update({getattr(model.fe, f"sa{i}").dense1: f"sa{i}.dense1"
                  for i in range(1, model.fe.n_sa + 1)})

    def linear(layer, x, dtype, inner=fused_sa.linear):
        if layer in dense:
            seen.setdefault(dense[layer], []).append(tuple(x.shape))
        return inner(layer, x, dtype)

    try:
        with mock.patch.object(fused_sa, "linear", linear), \
                mock.patch.object(layers, "linear", linear):
            yield
    finally:
        for h in hooks:
            h.remove()


def train_step(shape, cfg: DeepVCPConfig, tcfg: TrainConfig, state, batch, ring=False,
               local=None):
    """One sharded train step on a (data, point) mesh from `state` (model
    state dict as numpy) on the global `batch`; with `local` ("host-local"
    loading), the batch is instead this rank's stride of `local` = (dataset
    kwargs, per-host batch size), read through batch_iterator. Returns the
    metrics, the parameters and running statistics after the step, whether
    the point partition's gate passed and the input shapes of the per-point
    modules (_recording_inputs)."""
    from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
    from deepvcp_tpu_torch.parallel.mesh import DATA_AXIS, axis_index, axis_size
    from deepvcp_tpu_torch.train import create_train_state, make_train_step

    mesh = make_mesh(*shape, device="cpu")
    model = DeepVCP(cfg, knn_mesh=mesh if ring else None)
    model.load_state_dict({k: torch.from_numpy(v) for k, v in state.items()})
    ts, schedule = create_train_state(model, tcfg)
    step = make_train_step(model, schedule, tcfg, mesh=mesh)
    inputs = {}
    if local is None:
        args = shard_batch(mesh, batch)
    else:
        ds_kwargs, per_host = local
        ds = SyntheticDataset(**ds_kwargs)
        args = shard_batch(mesh, next(batch_iterator(
            ds, per_host, epoch=0, seed=0, host_id=axis_index(mesh, DATA_AXIS),
            num_hosts=axis_size(mesh, DATA_AXIS))), local=True)
    with _recording_inputs(model, inputs):
        ts, metrics = step(ts, *args)
    out = {k: float(v) for k, v in metrics.items()}
    print(f"rank {torch.distributed.get_rank()}: loss {out['loss']:.8f}", flush=True)
    return {"metrics": out, "params": _numpy(dict(model.named_parameters())),
            "stats": _numpy({n: b for n, b in model.named_buffers() if "running" in n}),
            "step": ts.step, "inputs": inputs,
            "split": model.partitions(mesh, args[0].shape[1], args[1].shape[1])}


def gather_grads(shape, x, w):
    """parallel.mesh's point_shard and gather_points in a loss of the kind
    the partitioned step computes: x [B, N, C] whole on every rank, w [C];
    this rank's rows h = point_shard(x) * w, g = gather_points(h) ** 2
    (replicated), the rank's rows of g's cumulative sum over the points,
    gathered again, summed into the loss. Each rank backpropagates loss / P.
    Returns the loss and the gradients of x and w, summed over the point
    group as the step sums its parameters'."""
    import torch.distributed as dist

    from deepvcp_tpu_torch.parallel.mesh import (
        POINT_AXIS, axis_group, axis_size, gather_points, point_shard)

    mesh = make_mesh(*shape, device="cpu")
    P = axis_size(mesh, POINT_AXIS)
    x, w = torch.from_numpy(x).requires_grad_(), torch.from_numpy(w).requires_grad_()
    g = gather_points(point_shard(x, mesh) * w, mesh) ** 2
    loss = gather_points(point_shard(torch.cumsum(g, dim=1), mesh), mesh).sin().sum()
    (loss / P).backward()
    grads = torch.cat([x.grad.reshape(-1), w.grad])
    dist.all_reduce(grads, group=axis_group(mesh, POINT_AXIS))
    return float(loss), grads[:x.numel()].reshape(x.shape).numpy(), grads[x.numel():].numpy()


def ring_knn(shape, ref, query, k, batch_axis=None, kernel=False):
    """ring_knn's (distances, indices); with `kernel`, run as where K6 runs
    (k6.uses_kernel true, k6.knn_select its plain version, each call's
    number of queries recorded), and that record as well."""
    from deepvcp_tpu_torch.ops.distributed import ring_knn as ring
    from deepvcp_tpu_torch.ops.kernels import knn_select as k6

    mesh = make_mesh(*shape, device="cpu")

    def run():
        d, i = ring(mesh, torch.from_numpy(ref), torch.from_numpy(query), k,
                    batch_axis=batch_axis)
        return d.numpy(), i.numpy()

    if not kernel:
        return run()
    seen = []

    def recorded(r, q, kk):
        seen.append(q.shape[1])
        return k6.knn_select_reference(r, q, kk)

    saved = k6.uses_kernel, k6.knn_select
    k6.uses_kernel, k6.knn_select = (lambda t: True), recorded
    try:
        return (*run(), seen)
    finally:
        k6.uses_kernel, k6.knn_select = saved


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


def late_mesh(shape, delay_s):
    """The last rank sleeps `delay_s` before make_mesh(*shape); no rank
    issues a collective after it. Returns this rank's mesh coordinate."""
    import time

    if torch.distributed.get_rank() == torch.distributed.get_world_size() - 1:
        time.sleep(delay_s)
    return make_mesh(*shape, device="cpu").get_coordinate()


def launch_env():
    """This rank's LOCAL_RANK (set by run_ranks) and its global rank."""
    import os

    return os.environ["LOCAL_RANK"], torch.distributed.get_rank()


def run_cases(cases):
    """Several bodies in one run of ranks: cases {name: (body, kwargs)} ->
    {name: the body's result}, in order, so that the tests of a file share
    one start of the ranks."""
    return {name: globals()[body](**kwargs) for name, (body, kwargs) in cases.items()}

