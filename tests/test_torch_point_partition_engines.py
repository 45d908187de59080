"""The port's point-partitioned train step under every FE engine and compute
dtype, over gloo ranks on the CPU: the windowed and dense engines (a rank
searches, groups and runs the MLP for its own queries), the static band (a
rank pools the tiles that hold its rows), bf16 compute (K1 / K2's plain
versions on f32 copies) and the source neighbourhoods among the keypoints
(dfe_src_neighbors="keypoints") on the exact slab.

Against the port's single-device step on the same global batch, with
tests/test_torch_point_partition.py's bounds (bf16: its own grad-norm
bound, BF16_GRAD_RTOL), on 1 x 2 and 1 x 4, the ranks equal; the input
shapes of the per-point modules on a rank; the 2 x 2 step's loss and mean
residual against the JAX package's 2 x 2 mesh step for the windowed engine
and the static band; the static band's row-restricted forward and backward
against the whole one; and the gate (DeepVCP.partitions).

The ranks are processes of parallel.launch.run_ranks running
tests/torch_ranks.py (no jax there): one run of 4 ranks and one of 2, at the
same time, while the parent runs the JAX steps.
"""

import concurrent.futures
import dataclasses
import os
import types

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
from deepvcp_tpu_torch.models.fused_sa import static_band_max_pool
from deepvcp_tpu_torch.parallel.launch import run_ranks
from test_torch_point_partition import (
    DS_KW, EXACT, GRAD_RTOL, LOSS_RTOL, RANKS_TIMEOUT_S, _assert_matches_single, _case,
    _single_step)

HERE = os.path.dirname(os.path.abspath(__file__))
# bf16: an f32 BatchNorm statistic one ulp off (the group sums its ranks'
# shares in another order) moves a bf16 rounding of the normalised
# activations by one bf16 step, 2^-8 of the value, and the gradients that
# flow through it with it. This file's bf16 step on the CPU read grad norm
# rel 1.10e-04 (1 x 2) and 5.29e-04 (1 x 4), loss rel 3.21e-06, parameters
# 1.97e-03 (< 2.5 lr), statistics 1.79e-07: the file's other bounds hold.
BF16_GRAD_RTOL = 2.0 ** -8
# the static band on tiles that rank rows do not align with: N = 320 over
# tiles of 24 (14 tiles; 160 and 80 rows a rank); window_safety 1 makes
# stage 1's band 13 of the 14 tiles and stage 3's wrap (23 tiles)
UNALIGNED = dict(use_pallas_band_max=False, band_tile=24, window_safety=1.0)
N_UNALIGNED = 320
CONFIGS = {
    "windowed": dict(neighbor_method="windowed"),
    "dense": dict(neighbor_method="dense"),
    "static band": dict(use_pallas_band_max=False),
    "static band, unaligned tiles": UNALIGNED,
    "bf16": dict(compute_dtype="bfloat16"),
    "keypoints": dict(dfe_src_neighbors="keypoints"),
}
JAX_CASES = ("windowed", "static band")


def _flax_state(jstate):
    variables = {"params": jax.device_get(jstate.params),
                 "batch_stats": jax.device_get(jstate.batch_stats)}
    return {k: v.numpy() for k, v in flax_to_torch(variables).items()}


@pytest.fixture(scope="module")
def setup():
    """tests/test_torch_point_partition.py's tiny model and batch, under
    each config of CONFIGS: {name: {cfg, state, batch, tcfg, jcfg, jstate,
    tx}}, the banded weights for the banded configs and the gather engines'
    (their first projection carries its bias) for the others."""
    jcfg = dataclasses.replace(JConfig.tiny(num_points=64, use_normal=False), **EXACT)
    jtcfg = JTrainConfig(batch_size=4, metrics_path=None)
    batch = next(jbatch_iterator(JSyntheticDataset(**DS_KW), 4, epoch=0, seed=0))
    wide = next(jbatch_iterator(JSyntheticDataset(**{**DS_KW, "num_points": N_UNALIGNED}), 4,
                                epoch=0, seed=0))
    states = {}
    for engine in ("banded", "windowed"):
        jstate, tx = jcreate_train_state(
            JDeepVCP(cfg=dataclasses.replace(jcfg, neighbor_method=engine)), jtcfg, batch)
        states[engine] = (jstate, tx, _flax_state(jstate))
    cfg = dataclasses.replace(DeepVCPConfig.tiny(num_points=64, use_normal=False), **EXACT)
    out = {}
    for name, changes in CONFIGS.items():
        jstate, tx, state = states["banded" if "neighbor_method" not in changes else "windowed"]
        n = N_UNALIGNED if changes is UNALIGNED else 64
        out[name] = dict(cfg=dataclasses.replace(cfg, num_points=n, **changes), state=state,
                         batch=wide if changes is UNALIGNED else batch, jstate=jstate, tx=tx,
                         tcfg=TrainConfig(batch_size=4, metrics_path=None), jtcfg=jtcfg,
                         jcfg=dataclasses.replace(jcfg, **changes))
    return out


def _jax_loss(case):
    """Loss and mean residual of the JAX package's step over a 2 x 2 mesh
    of its CPU devices (clouds split over "point" by GSPMD)."""
    mesh = jmake_mesh(devices=jax.devices()[:4], data=2, point=2)
    step = jmake_train_step(JDeepVCP(cfg=case["jcfg"]), case["tx"], case["jtcfg"], mesh=mesh)
    _, m = step(jax.tree_util.tree_map(jnp.copy, case["jstate"]),
                *jshard_batch(mesh, case["batch"]))
    return float(m["loss"]), float(m["mean_residual"])


@pytest.fixture(scope="module")
def ranks(setup):
    """Every config's split step over 4 gloo ranks (1 x 4, and 2 x 2 for
    JAX_CASES) and over 2 at the same time (1 x 2), while this process runs
    JAX's 2 x 2 steps: {case: [each rank's result]}, {name: JAX's (loss,
    mean residual)}."""
    four = {f"{name} (1, 4)": _case(case, (1, 4), ring=False) for name, case in setup.items()}
    four.update({f"{name} (2, 2)": _case(setup[name], (2, 2), ring=False) for name in JAX_CASES})
    two = {f"{name} (1, 2)": _case(case, (1, 2), ring=False) for name, case in setup.items()}
    runs = {4: four, 2: two}
    with concurrent.futures.ThreadPoolExecutor(len(runs)) as pool:
        futures = {world: pool.submit(
            run_ranks, "torch_ranks:run_cases", world, kwargs={"cases": cases}, device="cpu",
            sys_path=[HERE], timeout_s=RANKS_TIMEOUT_S) for world, cases in runs.items()}
        jax_losses = {name: _jax_loss(setup[name]) for name in JAX_CASES}
        got = {name: [r[name] for r in futures[world].result()]
               for world, cases in runs.items() for name in cases}
    return got, jax_losses


@pytest.mark.parametrize("shape", ["(1, 2)", "(1, 4)"])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_partitioned_step_matches_single_device(setup, ranks, name, shape):
    """The point group split over 2 and over 4 ranks under each config: the
    single-device step of the global batch, every rank the same step."""
    _assert_matches_single(ranks[0][f"{name} {shape}"], _single_step(setup[name]),
                           grad_rtol=BF16_GRAD_RTOL if name == "bf16" else GRAD_RTOL)


@pytest.mark.parametrize("name", JAX_CASES)
def test_partitioned_loss_matches_jax_sharded_step(setup, ranks, name):
    """Loss and mean residual (alpha 0.5) of the split 2 x 2 step against
    the JAX package's step over a 2 x 2 mesh, windowed engine and static
    band (the JAX CPU path pools over the static band under either
    use_pallas_band_max)."""
    got, jax_losses = ranks
    loss, residual = jax_losses[name]
    for r in got[f"{name} (2, 2)"]:
        assert r["split"]
        assert r["metrics"]["loss"] == pytest.approx(loss, rel=LOSS_RTOL)
        assert r["metrics"]["mean_residual"] == pytest.approx(residual, rel=LOSS_RTOL)


@pytest.mark.parametrize("shape,P", [("(1, 2)", 2), ("(1, 4)", 4)])
@pytest.mark.parametrize("name", list(CONFIGS))
def test_rank_computes_its_share(setup, ranks, name, shape, P):
    """A rank of a point group of P runs each SA stage's tail on its N / P
    rows of each cloud (the gather engines: its queries' nsample
    neighbours), the projection and the saliency on N / P rows, and the
    DFE and the CPG on K / P keypoints."""
    cfg = DeepVCP(setup[name]["cfg"]).cfg
    B, N, K, C, ns = 4, cfg.num_points, cfg.num_keypoints, cfg.num_candidates, cfg.num_neighbors
    width = 3 + cfg.feat_dim
    for r in ranks[0][f"{name} {shape}"]:
        seen = r["inputs"]
        for i, layer in enumerate(cfg.sa_layers, start=1):
            rows = (B, N // P) if cfg.neighbor_method == "banded" else (B, N // P, layer.nsample)
            assert seen[f"sa{i}.dense1"] == [rows + (layer.mlp[0],)] * 2
        assert seen["proj"] == [(B, N // P, cfg.sa_layers[-1].mlp[-1])] * 2
        assert seen["wl"] == [(B, N // P, cfg.feat_dim)]
        assert seen["dfe"] == [(B, K // P, ns, width), (B, K // P, C, ns, width)]
        assert seen["cpg"] == [(B, K // P, cfg.dfe_mlp[-1])]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("N,tile,window,P", [(64, 256, 64, 2), (64, 256, 64, 4),
                                             (320, 24, 128, 4), (320, 24, 256, 2)])
def test_static_band_rows_match_whole(N, tile, window, P, dtype):
    """static_band_max_pool restricted to a rank's rows (the tiles that hold
    them; the tiles and the band are the whole cloud's) against the whole
    one: the rows equal bit for bit, and the ranks' gradients of u, each
    from its rows' cotangent, sum to the whole gradient, the band's
    repeated tiles counted as often (N <= tile: 2 * half + 1 copies of the
    one tile). f32: rounding only; bf16: each rank's sum is rounded once to
    bf16, so within P bf16 steps of the largest."""
    rng = np.random.default_rng(11)
    xyz = rng.uniform(-2.0, 2.0, (2, N, 3)).astype(np.float32)
    xyz = torch.from_numpy(np.take_along_axis(xyz, np.argsort(xyz[..., :1], axis=1), axis=1))
    xyz = xyz.to(dtype)
    u = torch.from_numpy(rng.normal(size=(2, N, 8)).astype(np.float32)).to(dtype)
    g = torch.from_numpy(rng.normal(size=(2, N, 8)).astype(np.float32)).to(dtype)
    radius = 0.6
    whole_u = u.clone().requires_grad_()
    whole = static_band_max_pool(xyz, whole_u, radius, window, tile)
    (whole.float() * g.float()).sum().backward()
    total = torch.zeros(u.shape)
    for r in range(P):
        lo, hi = r * N // P, (r + 1) * N // P
        own_u = u.clone().requires_grad_()
        out = static_band_max_pool(xyz, own_u, radius, window, tile, rows=(lo, hi))
        assert torch.equal(out[:, lo:hi], whole[:, lo:hi].detach())
        (out[:, lo:hi].float() * g[:, lo:hi].float()).sum().backward()
        total += own_u.grad.float()
    want = whole_u.grad.float()
    if dtype == torch.float32:
        np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=1e-6, atol=1e-6)
    else:
        step = 2.0 ** (np.floor(np.log2(want.abs().max().item())) - 7)
        np.testing.assert_allclose(total.numpy(), want.numpy(), rtol=0, atol=P * step)


def _mesh(P):
    """A stand-in for a 1 x P ("data", "point") mesh: the gate reads its
    shape only."""
    return types.SimpleNamespace(shape=(1, P), mesh_dim_names=("data", "point"))


@pytest.mark.parametrize("name", list(CONFIGS))
def test_gate(name):
    """DeepVCP.partitions passes every engine and compute dtype at P = 2
    and 4 when P divides N and K and every SA stage keeps all N points as
    centroids; it refuses N or K that P does not divide, and a stage with
    npoint < N (the gather engines also npoint > N: their FPS is not
    split)."""
    base = dataclasses.replace(DeepVCPConfig.tiny(num_points=64, use_normal=False),
                               **CONFIGS[name])
    model = DeepVCP(base)
    for P in (2, 4):
        assert model.partitions(_mesh(P), 64, 64)
    assert not model.partitions(_mesh(1), 64, 64)
    assert not model.partitions(_mesh(4), 64, 62)
    assert not DeepVCP(dataclasses.replace(base, num_keypoints=18)).partitions(_mesh(4), 64, 64)
    sampled = dataclasses.replace(base, sa_layers=(
        dataclasses.replace(base.sa_layers[0], npoint=32),) + base.sa_layers[1:])
    assert not DeepVCP(sampled).partitions(_mesh(2), 64, 64)
    assert model.partitions(_mesh(2), 32, 32) == (base.neighbor_method == "banded")
