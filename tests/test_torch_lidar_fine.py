"""The lidar-fine configuration of the benchmark (benchmark/configs/lidar-fine.json)
on the port: its Registrar equals the plain reference (benchmark/reference)
bit for bit on 1 m lidar-like clouds, on seeded random weights and on the
registry's; the file is the registry's checkpoint config; and approx_knn's
tile arm, which selects its candidates, opens one deepvcp.select_tile range
per query chunk."""

import collections
import inspect
import os
import sys

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
if ROOT not in sys.path:
    sys.path.insert(0, ROOT)

from benchmark import generate, manifest, system  # noqa: E402
from benchmark.reference.deepvcp import Reference, load_npz  # noqa: E402
from deepvcp_tpu_torch import pretrained  # noqa: E402
from deepvcp_tpu_torch.ops.knn import approx_knn  # noqa: E402
from deepvcp_tpu_torch.registration import Registrar  # noqa: E402

N = 512
B = 2
CELL = "lidar-fine.stream-b8-1m"


@pytest.fixture(scope="module")
def cell():
    bench = manifest.load()
    w = manifest.workload(bench, CELL)
    return manifest.config(bench, w["config"]), manifest.traffic(w["traffic"])


@pytest.fixture(scope="module")
def pair(cell):
    _, traffic = cell
    pool = generate.make_pool(2 ** 33 + 5, dict(traffic, pool=B), N)
    return torch.from_numpy(pool.src), torch.from_numpy(pool.tgt)


def random_params(like, seed):
    """The npz's keys and shapes filled from a seeded generator: dense and
    conv kernels at 1 / sqrt(fan-in), BatchNorm variances in [0.5, 2]."""
    rng = np.random.default_rng(seed)
    out = {}
    for key, value in like.items():
        shape = value.shape
        if key.endswith("/kernel"):
            x = rng.standard_normal(shape) / np.sqrt(np.prod(shape[:-1]))
        elif key.endswith("/var"):
            x = rng.uniform(0.5, 2.0, shape)
        elif key.endswith("/scale"):
            x = rng.uniform(0.5, 1.5, shape)
        else:
            x = 0.1 * rng.standard_normal(shape)
        out[key] = x.astype(np.float32)
    return out


@pytest.mark.parametrize("weights", ["random", "registry"])
def test_registrar_equals_the_reference(cell, pair, weights):
    config, _ = cell
    config = dict(config, model=dict(config["model"], num_points=N))
    params = load_npz(os.path.join(ROOT, config["weights"]))
    if weights == "random":
        params = random_params(params, seed=21)
    torch.set_num_threads(4)
    out = system.registrar(config, params, torch.device("cpu"))(*pair)
    ref = Reference(config, params, torch.device("cpu")).register(*pair)
    for name in ("R", "t", "keypoints", "vcps", "saliency", "scores"):
        torch.testing.assert_close(getattr(out, name), ref[name], rtol=0, atol=0)


def test_config_file_is_the_registry_checkpoint(cell):
    config, _ = cell
    model = system.model_config(config)
    assert model == pretrained.config("lidar-fine")
    assert (model.grid_size, model.num_candidates) == (7, 343)
    assert model.knn_select_dtype_effective == "bfloat16" and model.tgt_knn == "flat"
    assert config["reduced"] == []
    assert config["weights"].endswith("/lidar-fine.npz")
    defaults = inspect.signature(Registrar.__init__).parameters
    assert config["registrar"] == {
        "refine_iters": pretrained.REGISTRY["lidar-fine"]["refine_iters"],
        "use_saliency_weights": True,   # pretrained.registrar's default
        "guard": defaults["guard"].default,
        "inlier_ratio": defaults["inlier_ratio"].default}


@pytest.mark.parametrize("select_dtype", ["bfloat16", None])
@pytest.mark.parametrize("chunk", [8, None])
def test_tile_arm_opens_one_select_tile_range_per_chunk(select_dtype, chunk):
    gen = torch.Generator().manual_seed(0)
    ref = torch.rand(2, 50, 3, generator=gen)
    query = torch.rand(2, 23, 3, generator=gen)
    plain = approx_knn(ref, query, 5, chunk=chunk, select_dtype=select_dtype)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        traced = approx_knn(ref, query, 5, chunk=chunk, select_dtype=select_dtype)
    names = collections.Counter(e.name() for e in prof.profiler.kineto_results.events()
                                if e.is_user_annotation())
    assert names == {"deepvcp.select_tile": 3 if chunk else 1}
    for a, b in zip(plain, traced):
        assert torch.equal(a, b)
