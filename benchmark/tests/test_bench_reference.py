"""The plain reference agrees with the port on the CPU at a small size on
the registry weights, for each configuration's path, and its TF32 switch
restores the settings it found."""

import pytest
import torch

from benchmark import generate, manifest, system
from benchmark.reference.deepvcp import Reference, load_npz, tf32
from benchmark.tests.helpers import small_cell


@pytest.mark.parametrize("cell", ["kitti25-rot.pair-b1", "kitti25-two-level.stream-b8"])
def test_reference_equals_the_port_on_cpu(cell):
    config, traffic, _ = small_cell(cell)
    params = load_npz(str(manifest.ROOT / config["weights"]))
    pool = generate.make_pool(3, dict(traffic, pool=2), config["model"]["num_points"])
    src, tgt = torch.from_numpy(pool.src), torch.from_numpy(pool.tgt)
    torch.set_num_threads(4)
    out = system.registrar(config, params, torch.device("cpu"))(src, tgt)
    ref = Reference(config, params, torch.device("cpu")).register(src, tgt)
    for name in ("R", "t", "keypoints", "vcps", "saliency", "scores"):
        torch.testing.assert_close(getattr(out, name), ref[name], rtol=0, atol=0)


def test_config_files_are_the_registry_entries():
    """Each configuration file's model is the port's registry config with the
    changes its file names, and its registrar the registry's defaults."""
    import dataclasses

    from deepvcp_tpu_torch import pretrained

    bench = manifest.load()
    for name, registry, changes in (("kitti25-rot", "kitti25-rot", {}),
                                    ("kitti25-two-level", "kitti25",
                                     {"tgt_knn": "two_level", "tgt_knn_table": 512})):
        config = manifest.config(bench, name)
        expected = dataclasses.replace(pretrained.config(registry), **changes)
        assert system.model_config(config) == expected
        assert config["registrar"]["refine_iters"] == pretrained.REGISTRY[registry]["refine_iters"]
        assert config["weights"].endswith(f"/{registry}.npz")


def test_tf32_switch_restores():
    before = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)
    with tf32(True):
        assert torch.backends.cuda.matmul.allow_tf32 and torch.backends.cudnn.allow_tf32
    assert (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32) == before
