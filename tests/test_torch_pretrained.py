"""The port's weights, configs and data against the JAX package's, and the
port's promise not to import jax."""

import ast
import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from deepvcp_tpu import data as jdata
from deepvcp_tpu import pretrained as jpretrained
from deepvcp_tpu.utils import rotations as jrot
from deepvcp_tpu_torch import pretrained
from deepvcp_tpu_torch.data import synthetic
from deepvcp_tpu_torch.models import DeepVCP

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _flatten(tree, prefix=""):
    for key, val in tree.items():
        path = f"{prefix}/{key}" if prefix else key
        if isinstance(val, dict):
            yield from _flatten(val, path)
        else:
            yield path, np.asarray(val)


def test_exported_weights_equal_checkpoint():
    """weights/kitti25-rot.npz holds the orbax checkpoint, array for array."""
    _assert_exported_equals_checkpoint("kitti25-rot")


@pytest.mark.parametrize("name", ["modelnet-coarse", "modelnet-fine"])
def test_exported_modelnet_weights_equal_checkpoint(name):
    """The two stages of modelnet-cascade, likewise."""
    _assert_exported_equals_checkpoint(name)


def test_exported_kitti25_weights_equal_checkpoint():
    """kitti25, the model the two-level path is validated on, likewise."""
    _assert_exported_equals_checkpoint("kitti25")


@pytest.mark.parametrize("name", ["lidar-fine", "kitti25-fine", "kitti25-ultra"])
def test_exported_odometry_and_routing_weights_equal_checkpoint(name):
    """The two fine stages of kitti-cascade and the routed registrar's lidar
    expert, likewise (the fine stages' grids reach the config through their
    .arch.json)."""
    _assert_exported_equals_checkpoint(name)


@pytest.mark.parametrize("name", sorted(pretrained.CAMPAIGN))
def test_exported_campaign_weights_equal_checkpoint(name):
    """Each exported campaign checkpoint (not registry entries: the windowed
    model_q5w and the reference-semantics model_r1c) holds its orbax
    checkpoint array for array, and its config is its campaign script's
    with the checkpoint's .arch.json applied."""
    entry = pretrained.CAMPAIGN[name]
    want = dict(_flatten(jax.device_get(
        jpretrained.load_variables(os.path.join(ROOT, entry["path"])))))
    got = dict(_flatten(pretrained.load_variables(name)))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    cfg = pretrained.campaign_config(name)
    model = DeepVCP(cfg)
    from deepvcp_tpu_torch.convert import flax_to_torch
    model.load_state_dict(flax_to_torch(pretrained.load_variables(name)), strict=True)
    if name == "campaign_r4b-q5w":
        assert (cfg.num_points, cfg.neighbor_method, cfg.window_safety, cfg.spatial_extent) == \
            (2048, "windowed", 6.0, 2.5)
        assert "proj_xyz/bias" in " ".join(got) and "bias0" not in " ".join(got)
    else:
        assert (cfg.num_points, cfg.neighbor_method, cfg.dfe_src_neighbors, cfg.centered_grid,
                cfg.derotate_tgt_neighborhoods) == (10000, "banded", "keypoints", False, False)


def _assert_exported_equals_checkpoint(name):
    cfg_j, want = jpretrained.load(name)
    cfg_t, got = pretrained.load(name)
    assert dataclasses.asdict(cfg_t) == dataclasses.asdict(cfg_j)
    want, got = dict(_flatten(jax.device_get(want))), dict(_flatten(got))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key].dtype == want[key].dtype, key
        np.testing.assert_array_equal(got[key], want[key], err_msg=key)
    assert sum(a.size for a in got.values()) == 35506


@pytest.mark.parametrize("name", sorted(jpretrained.REGISTRY))
@pytest.mark.parametrize("num_points,use_normal", [(10000, False), (2048, True)])
def test_config_matches_jax(monkeypatch, name, num_points, use_normal):
    """The port builds every registry entry's config as the JAX loader does
    (entry cfg + .arch.json provenance), field for field: the port's
    DeepVCPConfig is its own copy of the class. The JAX loader's weight
    restore is stubbed out: only its config is compared."""
    monkeypatch.setattr(jpretrained, "load_variables", lambda path: None)
    cfg_j, _ = jpretrained.load(name, num_points=num_points, use_normal=use_normal)
    assert dataclasses.asdict(pretrained.config(name, num_points, use_normal)) == \
        dataclasses.asdict(cfg_j)


def test_strict_load_and_registrar_defaults():
    cfg, variables = pretrained.load("kitti25-rot", num_points=256)
    assert cfg.spatial_extent == 55.0 and cfg.knn_select_dtype_effective is None
    reg = pretrained.registrar("kitti25-rot", device="cpu", num_points=256)
    assert (reg.refine_iters, reg.use_saliency_weights, reg.guard) == (3, True, True)
    model = DeepVCP(cfg)
    missing = model.load_state_dict(reg.model.state_dict(), strict=True)
    assert not missing.missing_keys and not missing.unexpected_keys
    n = sum(p.numel() for p in model.parameters()) + sum(
        b.numel() for name, b in model.named_buffers() if "running" in name)
    assert n == 35506


def test_unexported_checkpoint_is_reported(monkeypatch, tmp_path):
    """Every registry name is exported now, so the weights directory is
    pointed at an empty one: a name without its file is reported."""
    monkeypatch.setattr(pretrained, "WEIGHTS_DIR", str(tmp_path))
    with pytest.raises(FileNotFoundError, match="export_torch_weights"):
        pretrained.load("lidar-fine")
    with pytest.raises(KeyError):
        pretrained.config("no-such-model")


def test_every_registry_name_loads():
    """Each registry name has its exported weights, which load strictly into
    a Registrar with the JAX package's defaults, and both cascades and the
    routed registrar build."""
    for name in sorted(jpretrained.REGISTRY):
        reg = pretrained.registrar(name, device="cpu", num_points=256)
        assert reg.refine_iters == pretrained.REGISTRY[name]["refine_iters"]
        n = sum(p.numel() for p in reg.model.parameters()) + sum(
            b.numel() for key, b in reg.model.named_buffers() if "running" in key)
        assert n == 35506, name
    kitti = pretrained.cascade("kitti-cascade", device="cpu", num_points=256)
    assert [r.refine_iters for r in kitti.stages] == [2, 1, 2]
    assert [(r.cfg.search_radius, r.cfg.voxel_len) for r in kitti.stages] == \
        [(1.0, 0.4), (0.6, 0.2), (0.3, 0.1)]
    assert len(pretrained.cascade("modelnet-cascade", device="cpu", num_points=256).stages) == 2
    routed = pretrained.routed_registrar(device="cpu", num_points=256)
    assert (routed._reg.refine_iters, routed.threshold) == (3, 0.75)


@pytest.mark.parametrize("name", sorted(jpretrained.REGISTRY))
def test_registry_refine_iters_is_the_jax_default(monkeypatch, name):
    """Each name's refine_iters, an entry of the port's registry, is the
    default the JAX pretrained.registrar gives it (its special case for
    kitti25). The JAX Registrar is stubbed out: only its kwargs are read."""
    import deepvcp_tpu.registration as jregistration

    seen = {}
    monkeypatch.setattr(jpretrained, "load_variables", lambda path: None)
    monkeypatch.setattr(jregistration, "Registrar",
                        lambda cfg, variables, **kw: seen.update(kw))
    jpretrained.registrar(name)
    assert pretrained.REGISTRY[name]["refine_iters"] == seen["refine_iters"]
    assert pretrained.registrar(name, device="cpu", num_points=256).refine_iters == \
        seen["refine_iters"]


@pytest.mark.parametrize("seed,max_rotation_deg", [(110, 5.0), (7, None)])
def test_synthetic_pairs_bit_identical(seed, max_rotation_deg):
    """The numpy copy of the generator gives the JAX package's arrays, bit
    for bit: clouds, and pairs through batch_iterator (bounded and full
    SO(3) rotations, shuffled and not)."""
    kw = dict(num_clouds=3, num_points=500, max_range=25.0, seed=seed,
              max_rotation_deg=max_rotation_deg, max_translation=0.5)
    ours, theirs = synthetic.LidarLikeDataset(**kw), jdata.LidarLikeDataset(**kw)
    for a, b in zip(ours.clouds, theirs.clouds):
        np.testing.assert_array_equal(a, b)
    for shuffle in (False, True):
        got = list(synthetic.batch_iterator(ours, 1, epoch=0, seed=0, shuffle=shuffle))
        want = list(jdata.batch_iterator(theirs, 1, epoch=0, seed=0, shuffle=shuffle))
        assert len(got) == len(want) == 3
        for g, w in zip(got, want):
            for x, y in zip(g, w):
                assert x.dtype == y.dtype
                np.testing.assert_array_equal(x, y)


def test_pose_metrics():
    rng = np.random.default_rng(0)
    Ra = np.stack([synthetic.random_bounded_rotation(rng, 30.0) for _ in range(4)])
    Rb = np.stack([synthetic.random_rotation(rng) for _ in range(4)])
    ta, tb = rng.normal(size=(4, 3)), rng.normal(size=(4, 3))
    np.testing.assert_allclose(
        synthetic.rotation_geodesic_deg(torch.from_numpy(Ra), torch.from_numpy(Rb)).numpy(),
        np.asarray(jrot.rotation_geodesic_deg(Ra, Rb)), atol=1e-6)
    np.testing.assert_allclose(
        synthetic.translation_error(torch.from_numpy(ta), torch.from_numpy(tb)).numpy(),
        np.asarray(jrot.translation_error(ta, tb)), atol=1e-6)
    # small angles stay resolved in float32, where arccos of the trace gives 0
    small = torch.from_numpy(jrot.axis_angle_to_matrix([1.0, 2.0, 3.0], np.radians(0.01)))
    got = synthetic.rotation_geodesic_deg(small.float() @ torch.from_numpy(Rb).float(),
                                          torch.from_numpy(Rb).float())
    np.testing.assert_allclose(got.numpy(), 0.01, atol=2e-4)


def test_port_never_imports_jax():
    code = ("import sys\n"
            "import deepvcp_tpu_torch, deepvcp_tpu_torch.pretrained, deepvcp_tpu_torch.registration\n"
            "import deepvcp_tpu_torch.data, deepvcp_tpu_torch.ops.kernels\n"
            "import deepvcp_tpu_torch.train, deepvcp_tpu_torch.train.cli, deepvcp_tpu_torch.utils\n"
            "assert 'jax' not in sys.modules, sorted(m for m in sys.modules if 'jax' in m)\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr


def test_chip_smoke_imports_only_the_port():
    """chip_smoke.py imports neither jax nor the JAX package: it reaches the
    shared configs through deepvcp_tpu_torch."""
    with open(os.path.join(ROOT, "chip_smoke.py")) as fh:
        tree = ast.parse(fh.read())
    modules = [alias.name for node in ast.walk(tree) if isinstance(node, ast.Import)
               for alias in node.names]
    modules += [node.module for node in ast.walk(tree)
                if isinstance(node, ast.ImportFrom) and node.module]
    assert "deepvcp_tpu_torch.train" in modules
    top = {m.split(".")[0] for m in modules}
    assert not top & {"jax", "jaxlib", "flax", "optax", "deepvcp_tpu"}, sorted(top)
