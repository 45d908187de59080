"""The port's own copies of the configs and the registry
(deepvcp_tpu_torch/config.py, pretrained.py) against the JAX package's, and
the port's promise to import nothing of jax or of deepvcp_tpu."""

import dataclasses
import os
import subprocess
import sys

import pytest

from deepvcp_tpu import config as jconfig
from deepvcp_tpu import pretrained as jpretrained
from deepvcp_tpu_torch import config, pretrained

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROPERTIES = ("in_channels", "knn_select_dtype_effective", "use_approx_knn", "grid_reach",
              "use_two_level_tgt_knn", "grid_size", "num_candidates")


def assert_same_config(ours, theirs):
    """Every field (SA layers as plain dicts) and every property, before and
    after resolve()."""
    assert dataclasses.asdict(ours) == dataclasses.asdict(theirs)
    for name in PROPERTIES:
        assert getattr(ours, name) == getattr(theirs, name), name
    assert dataclasses.asdict(ours.resolve()) == dataclasses.asdict(theirs.resolve())


def _plain(value):
    """A default with the SA layers as dicts (the two packages' SALayerConfig
    are two classes, so their instances never compare equal)."""
    if isinstance(value, tuple):
        return tuple(_plain(v) for v in value)
    return dataclasses.asdict(value) if dataclasses.is_dataclass(value) else value


def test_fields_and_defaults_are_the_jax_ones():
    for ours, theirs in ((config.SALayerConfig, jconfig.SALayerConfig),
                         (config.DeepVCPConfig, jconfig.DeepVCPConfig),
                         (config.TrainConfig, jconfig.TrainConfig)):
        assert [(f.name, _plain(f.default)) for f in dataclasses.fields(ours)] == \
               [(f.name, _plain(f.default)) for f in dataclasses.fields(theirs)], ours.__name__
    assert dataclasses.asdict(config.TrainConfig()) == dataclasses.asdict(jconfig.TrainConfig())


@pytest.mark.parametrize("preset,kw", [
    ("__init__", {}), ("__init__", {"use_normal": False, "spatial_extent": 2.5}),
    ("tiny", {}), ("tiny", {"num_points": 512, "use_normal": False}),
    ("kitti_scale", {}), ("kitti_scale", {"num_points": 2048, "use_normal": True}),
])
def test_presets_match_jax(preset, kw):
    make = (lambda cls: cls(**kw)) if preset == "__init__" else \
        (lambda cls: getattr(cls, preset)(**kw))
    assert_same_config(make(config.DeepVCPConfig), make(jconfig.DeepVCPConfig))


@pytest.mark.parametrize("change", [
    {"neighbor_method": "window"}, {"keypoint_selection": "fps"}, {"keypoint_pool_mult": 0},
    {"candidate_knn": "fast"}, {"tgt_knn": "two"}, {"tgt_knn_table": 0},
    {"dfe_src_neighbors": "Cloud"}, {"spatial_extent": 0.5},
])
def test_resolve_refuses_what_jax_refuses(change):
    for cls in (config.DeepVCPConfig, jconfig.DeepVCPConfig):
        with pytest.raises(ValueError):
            dataclasses.replace(cls(), **change).resolve()


@pytest.mark.parametrize("name", sorted(jpretrained.REGISTRY))
def test_registry_configs_match_jax(monkeypatch, name):
    """Each registry entry's config as the JAX loader builds it (the JAX
    weight restore stubbed out: only its config is compared)."""
    monkeypatch.setattr(jpretrained, "load_variables", lambda path: None)
    cfg_j, _ = jpretrained.load(name)
    assert_same_config(pretrained.config(name), cfg_j)


def test_registry_and_cascades_are_the_jax_ones():
    assert pretrained._ARCH_FIELDS == jpretrained._ARCH_FIELDS
    assert sorted(pretrained.REGISTRY) == sorted(jpretrained.REGISTRY)
    for name, entry in jpretrained.REGISTRY.items():
        for key in ("path", "cfg", "gt_free", "notes"):
            assert pretrained.REGISTRY[name][key] == entry[key], (name, key)
    assert pretrained.CASCADES == jpretrained.CASCADES
    assert pretrained.available() == jpretrained.available()
    assert pretrained.available_cascades() == jpretrained.available_cascades()


def test_no_module_of_the_port_imports_jax_or_the_jax_package():
    """Import every module of deepvcp_tpu_torch in a fresh interpreter: neither
    jax nor anything of deepvcp_tpu may be loaded."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import deepvcp_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'deepvcp_tpu'))\n"
        "assert not bad, bad\n"
        "assert len(names) > 30, names\n"
        "print(len(names))\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=ROOT, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
