"""The port's point-partitioned train step (make_train_step with a ("data",
"point") mesh whose point group has P > 1 ranks) over gloo ranks on the
CPU: each rank of a point group computes its rows of each sorted cloud and
its K / P keypoints' descriptors, candidates, DFE and CPG, as GSPMD splits
the JAX step's per-point work.

Against the port's single-device step on the same global batch, with
tests/test_torch_parallel.py's bounds (loss rel 1e-4, RRE 0.05 deg, grad
norm rel 1e-3, parameters within 2.5 x lr, running statistics within
1e-5), the ranks equal; the 2 x 2 step's loss and mean residual against the
JAX package's 2 x 2 mesh step (rel 1e-4); the input shapes of the per-point
modules on a rank (the split is real); a shape off the gate (N not divisible
by P) taking the whole forward on every rank; and parallel.mesh's
point_shard / gather_points backward against one process's autograd.

The ranks are processes of parallel.launch.run_ranks running
tests/torch_ranks.py (no jax there): one run of 4 ranks and one of 2, at the
same time.
"""

import concurrent.futures
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig as JConfig
from deepvcp_tpu.config import TrainConfig as JTrainConfig
from deepvcp_tpu.data import SyntheticDataset as JSyntheticDataset
from deepvcp_tpu.data import batch_iterator as jbatch_iterator
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.parallel import make_mesh as jmake_mesh
from deepvcp_tpu.parallel import shard_batch as jshard_batch
from deepvcp_tpu.train.trainer import create_train_state as jcreate_train_state
from deepvcp_tpu.train.trainer import make_train_step as jmake_train_step
from deepvcp_tpu_torch.config import DeepVCPConfig, TrainConfig
from deepvcp_tpu_torch.convert import flax_to_torch
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.parallel.launch import run_ranks
from deepvcp_tpu_torch.train import create_train_state, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS_TIMEOUT_S = 150
LOSS_RTOL, RRE_ATOL, GRAD_RTOL, STAT_ATOL = 1e-4, 5e-2, 1e-3, 1e-5
PARAM_ATOL = 2.5 * 1e-3    # 2.5 x the step's lr
# the gathers' backward against one process's autograd: sums in another order
GATHER_RTOL = 1e-5
DS_KW = dict(num_clouds=8, num_points=64, extent=2.0)
# f32 selection on both sides, as tests/test_torch_parallel.py (bf16 tiles
# break k-th-distance ties differently in JAX and the port)
EXACT = dict(knn_select_dtype=None)
TWO_LEVEL = dict(tgt_knn="two_level", tgt_knn_table=32)
OFF_GATE_N = 62            # not divisible by 4 point ranks


@pytest.fixture(scope="module")
def setup():
    """tests/test_torch_parallel.py's tiny model, batch and JAX state, and
    the same weights as a port state dict."""
    jcfg = dataclasses.replace(JConfig.tiny(num_points=64, use_normal=False), **EXACT)
    jtcfg = JTrainConfig(batch_size=4, metrics_path=None)
    batch = next(jbatch_iterator(JSyntheticDataset(**DS_KW), 4, epoch=0, seed=0))
    jstate, tx = jcreate_train_state(JDeepVCP(cfg=jcfg), jtcfg, batch)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    state = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    cfg = dataclasses.replace(DeepVCPConfig.tiny(num_points=64, use_normal=False), **EXACT)
    off_gate = tuple(a[:, :OFF_GATE_N] if a.ndim == 3 and a.shape[1] == 64 else a
                     for a in batch)
    return dict(jcfg=jcfg, jtcfg=jtcfg, jstate=jstate, tx=tx, batch=batch, state=state,
                cfg=cfg, tcfg=TrainConfig(batch_size=4, metrics_path=None), off_gate=off_gate)


def _single_step(setup, cfg=None, batch=None):
    """The port's single-device step on the global batch."""
    model = DeepVCP(cfg or setup["cfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["state"].items()})
    ts, schedule = create_train_state(model, setup["tcfg"])
    step = make_train_step(model, schedule, setup["tcfg"])
    _, m = step(ts, *(torch.from_numpy(a) for a in (setup["batch"] if batch is None else batch)))
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().numpy() for n, p in model.named_parameters()},
            {n: b.numpy() for n, b in model.named_buffers() if "running" in n})


def _case(setup, shape, ring, cfg=None, batch=None):
    return ("train_step", dict(shape=shape, cfg=cfg or setup["cfg"], tcfg=setup["tcfg"],
                               state=setup["state"],
                               batch=setup["batch"] if batch is None else batch, ring=ring))


def _gather_inputs():
    rng = np.random.default_rng(5)
    return rng.normal(size=(2, 8, 3)).astype(np.float32), rng.normal(size=3).astype(np.float32)


@pytest.fixture(scope="module")
def ranks(setup):
    """Every partitioned case of the file, over 4 gloo ranks and over 2 at
    the same time: {case: [each rank's result]}."""
    x, w = _gather_inputs()
    two_level = dataclasses.replace(setup["cfg"], **TWO_LEVEL)
    four = {"(2, 2) ring": _case(setup, (2, 2), ring=True),
            "(1, 4)": _case(setup, (1, 4), ring=False),
            "(1, 4) off the gate": _case(setup, (1, 4), ring=True, batch=setup["off_gate"]),
            "gather (2, 2)": ("gather_grads", dict(shape=(2, 2), x=x, w=w)),
            "gather (1, 4)": ("gather_grads", dict(shape=(1, 4), x=x, w=w))}
    two = {"(1, 2)": _case(setup, (1, 2), ring=False),
           "(1, 2) two-level": _case(setup, (1, 2), ring=False, cfg=two_level)}
    runs = {4: four, 2: two}
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        futures = {world: pool.submit(
            run_ranks, "torch_ranks:run_cases", world, kwargs={"cases": cases}, device="cpu",
            sys_path=[HERE], timeout_s=RANKS_TIMEOUT_S) for world, cases in runs.items()}
    return {name: [r[name] for r in futures[world].result()]
            for world, cases in runs.items() for name in cases}


def _assert_matches_single(ranks, single, split=True, grad_rtol=GRAD_RTOL):
    m1, params1, stats1 = single
    for r in ranks:
        m2 = r["metrics"]
        assert r["step"] == 1
        assert r["split"] == split
        assert m2["loss"] == pytest.approx(m1["loss"], rel=LOSS_RTOL)
        assert m2["mean_residual"] == pytest.approx(m1["mean_residual"], rel=LOSS_RTOL)
        assert m2["rre_deg"] == pytest.approx(m1["rre_deg"], abs=RRE_ATOL)
        assert m2["grad_norm"] == pytest.approx(m1["grad_norm"], rel=grad_rtol)
        for n, p in params1.items():
            np.testing.assert_allclose(r["params"][n], p, atol=PARAM_ATOL, err_msg=n)
        for n, s in stats1.items():
            np.testing.assert_allclose(r["stats"][n], s, atol=STAT_ATOL, err_msg=n)
    # every rank took the same step
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for n in params1:
            np.testing.assert_array_equal(r["params"][n], ranks[0]["params"][n])


@pytest.mark.parametrize("shape", ["(1, 2)", "(2, 2) ring", "(1, 4)"])
def test_partitioned_step_matches_single_device(setup, ranks, shape):
    """The point group split over 2 ranks, 2 x 2 with the ring's own query
    shards, and over 4 ranks: the single-device step of the global batch."""
    _assert_matches_single(ranks[shape], _single_step(setup))


def test_partitioned_two_level_step_matches_single_device(setup, ranks):
    """tgt_knn="two_level": each rank builds the tables of its own
    keypoints only; the single-device two-level step."""
    cfg = dataclasses.replace(setup["cfg"], **TWO_LEVEL)
    _assert_matches_single(ranks["(1, 2) two-level"], _single_step(setup, cfg=cfg))


def test_partitioned_loss_matches_jax_sharded_step(setup, ranks):
    """Loss and mean residual (alpha 0.5) of the partitioned 2 x 2 step
    against the JAX package's step over a 2 x 2 mesh of its CPU devices
    (clouds split over "point" by GSPMD), both with the ring candidate KNN."""
    mesh = jmake_mesh(devices=jax.devices()[:4], data=2, point=2)
    step = jmake_train_step(JDeepVCP(cfg=setup["jcfg"], knn_mesh=mesh), setup["tx"],
                            setup["jtcfg"], mesh=mesh)
    state = jax.tree_util.tree_map(jnp.copy, setup["jstate"])
    _, m = step(state, *jshard_batch(mesh, setup["batch"]))
    for r in ranks["(2, 2) ring"]:
        assert r["metrics"]["loss"] == pytest.approx(float(m["loss"]), rel=LOSS_RTOL)
        assert r["metrics"]["mean_residual"] == pytest.approx(float(m["mean_residual"]),
                                                              rel=LOSS_RTOL)


@pytest.mark.parametrize("shape,B,P", [("(1, 2)", 4, 2), ("(2, 2) ring", 2, 2), ("(1, 4)", 4, 4)])
def test_rank_computes_its_share(setup, ranks, shape, B, P):
    """A rank of a point group of P runs the SA tails, the projection and
    the saliency on N / P rows of each cloud, and the DFE and the CPG on
    K / P keypoints: the source DFE on B (K / P) ns rows, the target DFE on
    B (K / P) C ns rows."""
    cfg = DeepVCP(setup["cfg"]).cfg
    N, K, C, ns = 64, cfg.num_keypoints, cfg.num_candidates, cfg.num_neighbors
    width = 3 + cfg.feat_dim
    for r in ranks[shape]:
        seen = r["inputs"]
        for i, layer in enumerate(cfg.sa_layers, start=1):
            assert seen[f"sa{i}.dense1"] == [(B, N // P, layer.mlp[0])] * 2
        assert seen["proj"] == [(B, N // P, cfg.sa_layers[-1].mlp[-1])] * 2
        assert seen["wl"] == [(B, N // P, cfg.feat_dim)]
        assert seen["dfe"] == [(B, K // P, ns, width), (B, K // P, C, ns, width)]
        assert np.prod(seen["dfe"][1][:-1]) == B * (K // P) * C * ns
        assert seen["cpg"] == [(B, K // P, cfg.dfe_mlp[-1])]


def test_shape_off_the_gate_takes_the_whole_forward(setup, ranks):
    """N = 62 over 4 point ranks fails the gate (62 % 4, and the ring's):
    every rank runs the whole forward, and the step is the single-device
    one on the same batch."""
    got = ranks["(1, 4) off the gate"]
    _assert_matches_single(got, _single_step(setup, batch=setup["off_gate"]), split=False)
    cfg = DeepVCP(setup["cfg"]).cfg
    for r in got:
        assert r["inputs"]["sa1.dense1"] == [(4, OFF_GATE_N, cfg.sa_layers[0].mlp[0])] * 2
        assert r["inputs"]["dfe"][1][1] == cfg.num_keypoints


@pytest.mark.parametrize("case", ["gather (2, 2)", "gather (1, 4)"])
def test_gather_backward_matches_one_process(ranks, case):
    """point_shard then gather_points, twice, in a loss each rank
    backpropagates 1 / P of: the gradients of the whole input and of a
    parameter, summed over the point group, are one process's autograd's
    (the gather's backward sums the ranks' cotangents and keeps the rank's
    rows; the slice's is zero outside them)."""
    x, w = (torch.from_numpy(a).requires_grad_() for a in _gather_inputs())
    loss = torch.cumsum((x * w) ** 2, dim=1).sin().sum()
    loss.backward()
    for got_loss, gx, gw in ranks[case]:
        assert got_loss == pytest.approx(loss.item(), rel=GATHER_RTOL)
        np.testing.assert_allclose(gx, x.grad.numpy(), rtol=GATHER_RTOL, atol=1e-6)
        np.testing.assert_allclose(gw, w.grad.numpy(), rtol=GATHER_RTOL, atol=1e-6)
