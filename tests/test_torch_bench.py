"""The port's headline bench (deepvcp_tpu_torch/bench.py, counterpart of the
root bench.py) on the CPU: its pairs are bench.py's, its path (the default
DeepVCPConfig under a Registrar with refine_iters 1 and the guard) gives
JAX's pose on JAX's own random init, a batch of pairs gives each pair's own
result, and the CLI prints the four-key JSON line last."""

import dataclasses
import json
import math
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import DeepVCPConfig as JDeepVCPConfig
from deepvcp_tpu.data import SyntheticDataset as JSyntheticDataset
from deepvcp_tpu.data import batch_iterator as jbatch_iterator
from deepvcp_tpu.models import DeepVCP as JDeepVCP
from deepvcp_tpu.registration import Registrar as JRegistrar
from deepvcp_tpu_torch import bench
from deepvcp_tpu_torch.config import DeepVCPConfig
from deepvcp_tpu_torch.data import SyntheticDataset, batch_iterator
from deepvcp_tpu_torch.registration import Registrar

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
POSE_ATOL = 1e-4   # R, t (and vcps, scores) after the two-pass Kabsch solve
# JAX on the CPU pools SA over a static band of window_for(N, ...) sorted
# points a side, which covers the exact slab (the port's K1) only where it
# reaches N: at N = 128 every window is the whole cloud
PARITY_N, PARITY_B = 128, 2
# bench.py's clouds (extent 10) at 128 points leave every point alone in
# its 0.1-0.4 m balls: all features, so all random-init saliencies, tie
# exactly and the two top-K break the ties differently. A 0.5 extent gives
# every point its own saliency
PARITY_EXTENT = 0.5


@pytest.mark.parametrize("num_points,batch", [(512, 1), (256, 3)])
def test_inputs_are_bench_py_pairs(num_points, batch):
    """bench.inputs builds, bit for bit, what bench.py:74-82 builds with the
    JAX package's SyntheticDataset and batch_iterator."""
    ds = JSyntheticDataset(num_clouds=batch, num_points=num_points, use_normal=False,
                           extent=10.0)
    want = next(jbatch_iterator(ds, batch, epoch=0, seed=0))
    got = bench.inputs(num_points, batch)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        assert g.dtype == w.dtype == np.float32
        np.testing.assert_array_equal(g, w)


@pytest.fixture(scope="module")
def parity():
    """bench.py's config and JAX init (jax.jit(model.init) at key 0) at
    PARITY_N, and a B = PARITY_B pair from bench.py's dataset at
    PARITY_EXTENT."""
    cfg = JDeepVCPConfig(num_points=PARITY_N, use_normal=False)
    ds = SyntheticDataset(num_clouds=PARITY_B, num_points=PARITY_N, use_normal=False,
                          extent=PARITY_EXTENT)
    src, tgt, R, t = next(batch_iterator(ds, PARITY_B, epoch=0, seed=0))
    variables = jax.device_get(jax.jit(JDeepVCP(cfg=cfg).init, static_argnames=("train",))(
        jax.random.key(0), jnp.asarray(src), jnp.asarray(tgt), jnp.asarray(R), jnp.asarray(t),
        train=False))
    return cfg, variables, src, tgt


@pytest.mark.parametrize("select", ["bfloat16", None], ids=["bench-bf16-tile", "f32-selection"])
@pytest.mark.parametrize("guard", [True, False], ids=["guard", "no-guard"])
def test_bench_path_matches_jax(parity, select, guard):
    """The bench path (Registrar under DeepVCPConfig(num_points=N,
    use_normal=False)) against JAX's Registrar on JAX's own key-0 init,
    carried over by convert.flax_to_torch: the same keypoints, then R and t
    within POSE_ATOL, with the guard (the registrar's default) and without
    it (the refinement's own pose; with random weights the guard keeps the
    identity init on these pairs). bench.py's path selects candidates on a
    bf16 tile, where the two packages' f32 sums differ in their last bits
    and near-ties of the 32nd distance swap (measured here: vcps 6.6e-4
    apart, the unguarded pose 4.3e-5); with f32 selection on both sides the
    vcps are held too."""
    cfg_j, variables, src, tgt = parity
    cfg_j = dataclasses.replace(cfg_j, knn_select_dtype=select)
    cfg = DeepVCPConfig(num_points=PARITY_N, use_normal=False, knn_select_dtype=select)
    assert cfg.knn_select_dtype_effective == select
    out_j = JRegistrar(cfg_j, variables, guard=guard)(jnp.asarray(src), jnp.asarray(tgt))
    out_t = Registrar(cfg, variables, "cpu", guard=guard)(torch.from_numpy(src),
                                                          torch.from_numpy(tgt))
    np.testing.assert_array_equal(out_t.keypoints.numpy(), np.asarray(out_j.keypoints))
    np.testing.assert_allclose(out_t.R.numpy(), np.asarray(out_j.R), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.t.numpy(), np.asarray(out_j.t), atol=POSE_ATOL)
    np.testing.assert_allclose(out_t.scores.numpy(), np.asarray(out_j.scores), atol=POSE_ATOL)
    if select is None:
        np.testing.assert_allclose(out_t.vcps.numpy(), np.asarray(out_j.vcps), atol=POSE_ATOL)


def test_batch_equals_its_pairs_alone():
    """On the CPU one B = 3 bench call gives each pair what its own B = 1
    call gives, bit for bit."""
    N = 256
    cfg = DeepVCPConfig(num_points=N, use_normal=False)
    src, tgt, _, _ = (torch.from_numpy(a) for a in bench.inputs(N, 3))
    reg = Registrar(cfg, bench.random_state(cfg, seed=0), "cpu")
    out = reg(src, tgt)
    for b in range(3):
        one = reg(src[b:b + 1], tgt[b:b + 1])
        for field in ("R", "t", "keypoints", "vcps", "inlier_idx", "saliency", "scores"):
            assert torch.equal(getattr(one, field)[0], getattr(out, field)[b]), (b, field)


def test_random_state_is_seeded():
    """The random init is a function of the seed alone, not of torch's
    global generator: the same seed gives the same state, another seed
    another; every Linear and Conv3d weight lies within torch's default
    +-1/sqrt(fan_in), and the SA stages' bias0 stays 0."""
    cfg = DeepVCPConfig(num_points=256, use_normal=False)
    a = bench.random_state(cfg, 0)
    torch.manual_seed(123)
    b, c = bench.random_state(cfg, 0), bench.random_state(cfg, 1)
    assert a.keys() == b.keys() == c.keys()
    assert all(torch.equal(a[k], b[k]) for k in a)
    assert all(not torch.equal(a[k], c[k]) for k in a if k.endswith(".weight") and a[k].dim() > 1)
    for k in ("fe.sa2.proj_feat.weight", "dfe.Dense_0.weight", "cpg.Conv_0.weight"):
        w = a[k]
        bound = 1.0 / math.sqrt(w[0].numel())
        assert w.abs().max() <= bound and w.abs().max() > 0.9 * bound, k
    assert not a["fe.sa1.bias0"].any()


def test_cli_prints_the_four_key_line_last():
    """python -m deepvcp_tpu_torch.bench --cpu at 256 points, B = 2: exit 0,
    its progress on standard error, and the JSON line last on standard
    output."""
    proc = subprocess.run(
        [sys.executable, "-m", "deepvcp_tpu_torch.bench", "--cpu", "--num-points", "256",
         "--batch", "2", "--iters", "1", "--warmup", "1"],
        cwd=ROOT, capture_output=True, text=True, timeout=300,
        env={**os.environ, "OMP_NUM_THREADS": "4"})
    assert proc.returncode == 0, proc.stderr[-3000:]
    for prefix in ("device: cpu", "init: ", "build + first run: ", "per-call latency best: "):
        assert prefix in proc.stderr, prefix
    last = json.loads(proc.stdout.strip().splitlines()[-1])
    assert set(last) == {"metric", "value", "unit", "vs_baseline"}
    assert last["metric"] == "torch_registration_pairs_per_sec" and last["unit"] == "pairs/s"
    assert math.isfinite(last["value"]) and last["value"] > 0
    assert last["vs_baseline"] == round(last["value"] / bench.BASELINE_PAIRS_PER_SEC, 2)
