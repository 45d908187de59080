"""The port's data-parallel train step (deepvcp_tpu_torch.train.make_train_step
with a ("data", "point") mesh) over gloo ranks on the CPU, against the port's
single-device step on the same global batch, with tests/test_parallel.py's
bounds (loss rel 1e-4, RRE 0.05 deg, grad norm rel 1e-3, parameters within
2.5 x lr) and the BatchNorm running statistics within 1e-5; its loss and
mean residual against the JAX package's sharded step (rel 1e-4); the mesh
layout against JAX make_mesh; initialize_multihost's failures; and
batch_iterator's host strides against JAX's.

The ranks are processes of parallel.launch.run_ranks running
tests/torch_ranks.py (no jax there); the file's sharded steps share two
runs of ranks (one of 4 ranks, one of 2). The port's single-device step is
held against JAX's in tests/test_torch_train.py.
"""

import concurrent.futures
import dataclasses
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

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
from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
from deepvcp_tpu_torch.models import DeepVCP
from deepvcp_tpu_torch.parallel import initialize_multihost, make_mesh
from deepvcp_tpu_torch.parallel.launch import run_ranks
from deepvcp_tpu_torch.parallel.mesh import axis_index, axis_peers
from deepvcp_tpu_torch.train import create_train_state, make_train_step

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
RANKS_TIMEOUT_S = 150
LOSS_RTOL, RRE_ATOL, GRAD_RTOL, STAT_ATOL = 1e-4, 5e-2, 1e-3, 1e-5
JITTER = dict(init_translation="gt", init_rot_jitter_deg=6.0, init_trans_jitter=0.5)
DS_KW = dict(num_clouds=8, num_points=64, extent=2.0)
# the ring KNN selects exactly in f32; the flat path's default bf16 selection
# tile swaps neighbours near the k-th distance, which moves the mean residual
# (a near-cancelling mean) by ~1e-3 of itself. Every step here selects in f32.
EXACT = dict(knn_select_dtype=None)


@pytest.fixture(scope="module")
def setup():
    """tests/test_parallel.py's tiny model, batch and JAX state, and the same
    weights as a port state dict."""
    jcfg = dataclasses.replace(JConfig.tiny(num_points=64, use_normal=False), **EXACT)
    jtcfg = JTrainConfig(batch_size=4, metrics_path=None)
    batch = next(jbatch_iterator(JSyntheticDataset(**DS_KW), 4, epoch=0, seed=0))
    jstate, tx = jcreate_train_state(JDeepVCP(cfg=jcfg), jtcfg, batch)
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    state = {k: v.numpy() for k, v in flax_to_torch(variables).items()}
    cfg = dataclasses.replace(DeepVCPConfig.tiny(num_points=64, use_normal=False), **EXACT)
    tcfg = TrainConfig(batch_size=4, metrics_path=None)
    return dict(jcfg=jcfg, jtcfg=jtcfg, jstate=jstate, tx=tx, batch=batch, state=state,
                cfg=cfg, tcfg=tcfg)


def _single_step(setup, tcfg, batch=None):
    """The port's single-device step on the global batch."""
    model = DeepVCP(setup["cfg"])
    model.load_state_dict({k: torch.from_numpy(v) for k, v in setup["state"].items()})
    ts, schedule = create_train_state(model, tcfg)
    step = make_train_step(model, schedule, tcfg)
    _, m = step(ts, *(torch.from_numpy(a) for a in (batch or setup["batch"])))
    return ({k: float(v) for k, v in m.items()},
            {n: p.detach().numpy() for n, p in model.named_parameters()},
            {n: b.numpy() for n, b in model.named_buffers() if "running" in n})


def _case(setup, shape, tcfg=None, **kw):
    return ("train_step", dict(shape=shape, cfg=setup["cfg"], tcfg=tcfg or setup["tcfg"],
                               state=setup["state"], batch=setup["batch"],
                               ring=shape[1] > 1, **kw))


@pytest.fixture(scope="module")
def sharded(setup):
    """Every sharded step of the file, over 4 gloo ranks and over 2 at the
    same time: {case: [each rank's result]}."""
    jitter = dataclasses.replace(setup["tcfg"], **JITTER)
    four = {"(2, 2)": _case(setup, (2, 2)), "(1, 4)": _case(setup, (1, 4)),
            "(2, 2) jitter": _case(setup, (2, 2), jitter)}
    two = {"(2, 1)": _case(setup, (2, 1)),
           "host-local": _case(setup, (2, 1), local=(DS_KW, 2))}
    runs = {world: (world, cases) for world, cases in ((4, four), (2, two))}
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        futures = {world: pool.submit(
            run_ranks, "torch_ranks:run_cases", world, kwargs={"cases": cases}, device="cpu",
            sys_path=[HERE], timeout_s=RANKS_TIMEOUT_S) for world, cases in runs.values()}
    return {name: [r[name] for r in futures[world].result()]
            for world, cases in runs.values() for name in cases}


def _assert_matches_single(ranks, single):
    m1, params1, stats1 = single
    for r in ranks:
        m2 = r["metrics"]
        assert r["step"] == 1
        assert m2["loss"] == pytest.approx(m1["loss"], rel=LOSS_RTOL)
        assert m2["mean_residual"] == pytest.approx(m1["mean_residual"], rel=LOSS_RTOL)
        assert m2["rre_deg"] == pytest.approx(m1["rre_deg"], abs=RRE_ATOL)
        assert m2["grad_norm"] == pytest.approx(m1["grad_norm"], rel=GRAD_RTOL)
        for n, p in params1.items():
            np.testing.assert_allclose(r["params"][n], p, atol=2.5 * 1e-3, err_msg=n)
        for n, s in stats1.items():
            np.testing.assert_allclose(r["stats"][n], s, atol=STAT_ATOL, err_msg=n)
    # every rank took the same step
    for r in ranks[1:]:
        assert r["metrics"] == ranks[0]["metrics"]
        for n in params1:
            np.testing.assert_array_equal(r["params"][n], ranks[0]["params"][n])


@pytest.mark.parametrize("shape", ["(2, 1)", "(2, 2)", "(1, 4)"])
def test_sharded_step_matches_single_device(setup, sharded, shape):
    """Data parallel over 2 ranks, 2 x 2 with the ring candidate KNN over
    each point group, and one data rank of 4 point ranks."""
    _assert_matches_single(sharded[shape], _single_step(setup, setup["tcfg"]))


def test_sharded_step_with_jittered_init(setup, sharded):
    """The residual recipe's warm-start jitter: every data rank takes its
    rows of the global batch's draw, so the step is the single-device one."""
    tcfg = dataclasses.replace(setup["tcfg"], **JITTER)
    _assert_matches_single(sharded["(2, 2) jitter"], _single_step(setup, tcfg))


def test_sharded_loss_matches_jax_sharded_step(setup, sharded):
    """Loss and mean residual (alpha 0.5) of the 2 x 2 step against the JAX
    package's step over a 2 x 2 mesh of its CPU devices, both with the ring
    candidate KNN."""
    mesh = jmake_mesh(devices=jax.devices()[:4], data=2, point=2)
    step = jmake_train_step(JDeepVCP(cfg=setup["jcfg"], knn_mesh=mesh), setup["tx"],
                            setup["jtcfg"], mesh=mesh)
    state = jax.tree_util.tree_map(jnp.copy, setup["jstate"])
    _, m = step(state, *jshard_batch(mesh, setup["batch"]))
    got = sharded["(2, 2)"][0]["metrics"]
    assert got["loss"] == pytest.approx(float(m["loss"]), rel=LOSS_RTOL)
    assert got["mean_residual"] == pytest.approx(float(m["mean_residual"]), rel=LOSS_RTOL)


def test_two_process_host_local_shards(setup, sharded):
    """Two processes, each loading its own stride of the index stream
    (batch_iterator(host_id, num_hosts)): both report the same loss, that of
    the single-device step on the two strides' pairs together."""
    ranks = sharded["host-local"]
    assert ranks[0]["metrics"]["loss"] == ranks[1]["metrics"]["loss"]
    ds = SyntheticDataset(**DS_KW)
    parts = [next(batch_iterator(ds, 2, epoch=0, seed=0, host_id=h, num_hosts=2))
             for h in range(2)]
    union = tuple(np.concatenate(a) for a in zip(*parts))
    _assert_matches_single(ranks, _single_step(setup, setup["tcfg"], union))


@pytest.mark.parametrize("shape", [(4, 1), (2, 2), (1, 4)])
def test_mesh_layout_matches_jax(shape):
    """Rank r's coordinates and its data and point groups in make_mesh's
    layout are those of device r in JAX make_mesh's, for every r (one
    process as each rank of a fake 4-rank group)."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    jm = jmake_mesh(devices=jax.devices()[:4], data=shape[0], point=shape[1])
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    for rank in range(4):
        dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=4)
        try:
            mesh = make_mesh(*shape, device="cpu")
            assert mesh.mesh.tolist() == ids.tolist()
            (d,), (p,) = np.nonzero(ids == rank)
            assert (axis_index(mesh, "data"), axis_index(mesh, "point")) == (d, p)
            assert axis_peers(mesh, "data") == ids[:, p].tolist()
            assert axis_peers(mesh, "point") == ids[d, :].tolist()
        finally:
            dist.destroy_process_group()


def test_initialize_multihost_explicit_failure_raises():
    """An explicitly configured run that cannot rendezvous raises instead of
    going on single-process (in a fresh interpreter: the process group is
    global state)."""
    code = ("from deepvcp_tpu_torch.parallel import initialize_multihost\n"
            "try:\n"
            "    initialize_multihost('localhost:1', 2, 1, device='cpu', timeout_s=1)\n"
            "except RuntimeError as e:\n"
            "    print('RAISED', e)\n"
            "else:\n"
            "    print('SILENT')\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=120, cwd=ROOT, env={**os.environ, "PYTHONPATH": ROOT})
    assert "RAISED init_process_group failed" in out.stdout, out.stdout + out.stderr[-2000:]


def test_initialize_multihost_without_environment_warns(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        monkeypatch.delenv(k, raising=False)
    with pytest.warns(UserWarning, match="MASTER_ADDR"):
        assert initialize_multihost(device="cpu") is False
    assert not dist.is_initialized()


def test_batch_iterator_host_strides_match_jax():
    """Each host's batches are JAX's: the shuffled stream's stride
    host_id::num_hosts."""
    jds, ds = JSyntheticDataset(**DS_KW), SyntheticDataset(**DS_KW)
    for host in range(2):
        got = list(batch_iterator(ds, 2, epoch=1, seed=3, host_id=host, num_hosts=2))
        want = list(jbatch_iterator(jds, 2, epoch=1, seed=3, host_id=host, num_hosts=2))
        assert len(got) == len(want) == 2
        for g, w in zip(got, want):
            for a, b in zip(g, w):
                np.testing.assert_array_equal(a, b)
