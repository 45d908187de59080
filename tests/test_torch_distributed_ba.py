"""The port's sharded pose graph (optimize_pose_graph_sharded) and landmark
bundle adjustment with a mesh (optimize_landmark_ba(mesh=...)) over gloo
ranks on the CPU: edges or observations split over the mesh's "data"
group, normal equations summed with all_reduce.

Held, as tests/test_distributed_ba.py and test_landmark_ba.py hold JAX's: the
sharded pose graph against the port's dense one and against the JAX
package's sharded one (on 2 and 4 of its CPU devices) within 0.1 deg and
5e-3, including 10 edges over 4 ranks (padding); BA with a mesh against BA
without within 0.05 deg and 2e-3, including observations that do not divide
the ranks. Every case runs in one run of 4 ranks (tests/torch_ranks.py).
"""

import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu.odometry import pose_graph as jpg
from deepvcp_tpu.parallel import make_mesh as jmake_mesh
from deepvcp_tpu_torch.odometry import pose_graph as tpg
from deepvcp_tpu_torch.parallel.launch import run_ranks
from deepvcp_tpu_torch.utils import rotation_geodesic_deg

HERE = os.path.dirname(os.path.abspath(__file__))
GRAPH_DEG, GRAPH_ATOL = 0.1, 5e-3
BA_DEG, BA_ATOL = 0.05, 2e-3


def _t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def _exp(w):
    return tpg.exp_so3(_t(w)[None])[0].double().numpy()


def _trajectory(F, rng, noise=0.03):
    """tests/test_distributed_ba.py's noisy trajectory: (true R, true t,
    noisy relative R, noisy relative t)."""
    R_abs, t_abs = [np.eye(3)], [np.zeros(3)]
    for _ in range(F - 1):
        R_abs.append(R_abs[-1] @ _exp(rng.uniform(-0.1, 0.1, 3)))
        t_abs.append(t_abs[-1] + rng.uniform(-1, 1, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    R_rel, t_rel = [], []
    for i in range(F - 1):
        R_rel.append(R_abs[i + 1].T @ R_abs[i] @ _exp(rng.normal(0, noise, 3)))
        t_rel.append(R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1]) + rng.normal(0, noise, 3))
    return R_abs, t_abs, np.stack(R_rel).astype(np.float32), np.stack(t_rel).astype(np.float32)


def _graph(seed, loops):
    """9 frames, 8 sequential edges and loop closures 0 -> k for k in loops:
    the graph's arrays and the chained initial poses, as numpy."""
    R_abs, t_abs, R_rel, t_rel = _trajectory(9, np.random.default_rng(seed))
    extra = [(0, k, R_abs[k].T @ R_abs[0], R_abs[k].T @ (t_abs[0] - t_abs[k])) for k in loops]
    g = tpg.build_graph(_t(R_rel), _t(t_rel), extra_edges=extra)
    R0, t0 = tpg.chain_poses(_t(R_rel), _t(t_rel))
    return tuple(a.numpy() for a in g), R0.numpy(), t0.numpy()


GRAPHS = {"8 edges": (_graph(0, ()), 8), "10 edges": (_graph(1, (4, 8)), 6)}


def _ba_scene(seed, F=6, L=40, drop=0):
    """tests/test_landmark_ba.py's scene, its last `drop` observations left
    out: (graph arrays, R0, t0, landmarks0, observation arrays)."""
    rng = np.random.default_rng(seed)
    R_abs, t_abs = [np.eye(3)], [np.zeros(3)]
    for _ in range(F - 1):
        R_abs.append(R_abs[-1] @ _exp(rng.uniform(-0.08, 0.08, 3)))
        t_abs.append(t_abs[-1] + rng.uniform(-0.5, 0.5, 3))
    R_abs, t_abs = np.stack(R_abs), np.stack(t_abs)
    lms = rng.uniform(-5, 5, (L, 3))
    frame = np.repeat(np.arange(F), L)
    lm = np.tile(np.arange(L), F)
    xyz = np.einsum("oba,ob->oa", R_abs[frame], lms[lm] - t_abs[frame]) + \
        rng.normal(0, 0.005, (F * L, 3))
    dw, dt = rng.normal(0, 0.05, (F, 3)), rng.normal(0, 0.15, (F, 3))
    dw[0], dt[0] = 0.0, 0.0
    R0 = np.einsum("fab,fbc->fac", R_abs, np.stack([_exp(w) for w in dw])).astype(np.float32)
    t0 = (t_abs + dt).astype(np.float32)
    lm0 = (lms + rng.normal(0, 0.1, lms.shape)).astype(np.float32)
    R_rel = np.stack([R_abs[i + 1].T @ R_abs[i] for i in range(F - 1)])
    t_rel = np.stack([R_abs[i + 1].T @ (t_abs[i] - t_abs[i + 1]) for i in range(F - 1)])
    graph = tuple(a.numpy() for a in tpg.build_graph(_t(R_rel), _t(t_rel)))
    keep = slice(0, F * L - drop)
    obs = (frame[keep].astype(np.int64), lm[keep].astype(np.int64),
           xyz[keep].astype(np.float32), np.ones(F * L - drop, np.float32))
    return graph, R0, t0, lm0, obs


BA = {"no graph": (_ba_scene(2), False), "with graph": (_ba_scene(2), True),
      "237 observations": (_ba_scene(3, drop=3), True)}


@pytest.fixture(scope="module")
def ranks():
    cases = {}
    for name, ((graph, R0, t0), iters) in GRAPHS.items():
        for shape in ((2, 2), (4, 1)):
            cases[f"{name} {shape[0]}"] = ("pose_graph", dict(
                shape=shape, graph=graph, R0=R0, t0=t0, num_iters=iters))
    for name, ((graph, R0, t0, lm0, obs), with_graph) in BA.items():
        cases[name] = ("landmark_ba", dict(shape=(4, 1), graph=graph if with_graph else None,
                                           R0=R0, t0=t0, lm0=lm0, obs=obs, num_iters=6))
    per_rank = run_ranks("torch_ranks:run_cases", 4, kwargs={"cases": cases}, device="cpu",
                         sys_path=[HERE], timeout_s=150)
    return {name: [r[name] for r in per_rank] for name in cases}


def _assert_close(got, want, deg, atol):
    assert rotation_geodesic_deg(_t(got[0]), _t(want[0])).max() < deg
    np.testing.assert_allclose(got[1], want[1], atol=atol)


@pytest.mark.parametrize("data", [2, 4])
@pytest.mark.parametrize("name", list(GRAPHS))
def test_sharded_pose_graph_matches_dense_and_jax(ranks, name, data):
    """Edges over 2 data ranks (a 2 x 2 mesh) and over 4 (4 x 1): the same
    poses on every rank, within 0.1 deg / 5e-3 of the port's dense solve and
    of JAX's sharded solve over as many devices."""
    (graph, R0, t0), iters = GRAPHS[name]
    dense = tpg.optimize_pose_graph(tpg.PoseGraph(*(torch.from_numpy(a) for a in graph)),
                                    _t(R0), _t(t0), num_iters=iters)
    jgraph = jpg.PoseGraph(*(jnp.asarray(a.astype(np.int32) if a.dtype == np.int64 else a)
                             for a in graph))
    want_jax = jpg.optimize_pose_graph_sharded(
        jgraph, jnp.asarray(R0), jnp.asarray(t0),
        jmake_mesh(devices=jax.devices()[:data], data=data, point=1), num_iters=iters)
    results = ranks[f"{name} {data}"]
    for got in results:
        _assert_close(got, tuple(a.numpy() for a in dense), GRAPH_DEG, GRAPH_ATOL)
        _assert_close(got, tuple(np.asarray(a) for a in want_jax), GRAPH_DEG, GRAPH_ATOL)
        for a, b in zip(got, results[0]):
            np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", list(BA))
def test_landmark_ba_with_mesh_matches_unsharded(ranks, name):
    """Observations over 4 ranks (237 of them: padded with zero-weight
    observations) against the unsharded solve: poses within 0.05 deg and
    2e-3, landmarks within 2e-3."""
    (graph, R0, t0, lm0, obs), with_graph = BA[name]
    g = tpg.PoseGraph(*(torch.from_numpy(a) for a in graph)) if with_graph else None
    want = tpg.optimize_landmark_ba(g, _t(R0), _t(t0), _t(lm0),
                                    tpg.LandmarkObs(*(torch.from_numpy(a) for a in obs)),
                                    num_iters=6)
    want = tuple(a.numpy() for a in want)
    for got in ranks[name]:
        _assert_close(got[:2], want[:2], BA_DEG, BA_ATOL)
        np.testing.assert_allclose(got[2], want[2], atol=BA_ATOL)
