"""The port's visualisation and export (deepvcp_tpu_torch/utils/vis.py)
against deepvcp_tpu/utils/vis.py: the same files byte for byte on the same
inputs, and the training CLI's --save-vis on the CPU."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from deepvcp_tpu.utils import vis as jvis
from deepvcp_tpu_torch.utils import vis as tvis

torch.set_num_threads(2)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _clouds(seed, n=300):
    rng = np.random.default_rng(seed)
    return (rng.uniform(-1, 1, (n, 3)).astype(np.float32),
            rng.uniform(-1, 1, (n, 3)).astype(np.float32))


def _bytes(path):
    with open(path, "rb") as fh:
        return fh.read()


def test_save_and_load_cloud_pairs_byte_identical(tmp_path):
    for i in range(3):
        gt, pred = _clouds(i)
        jvis.save_cloud_pair(str(tmp_path / "jax"), i, gt, pred)
        tvis.save_cloud_pair(str(tmp_path / "port"), i, gt, pred)
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) and len(names) == 6
    for n in names:
        assert _bytes(tmp_path / "jax" / n) == _bytes(tmp_path / "port" / n), n
    got = tvis.load_cloud_pairs(str(tmp_path / "port"))
    want = jvis.load_cloud_pairs(str(tmp_path / "jax"))
    assert len(got) == 3
    for (g0, p0), (g1, p1) in zip(got, want):
        np.testing.assert_array_equal(g0, g1)
        np.testing.assert_array_equal(p0, p1)


@pytest.mark.parametrize("with_colors", [False, True])
def test_write_pcd_byte_identical(tmp_path, with_colors):
    pts, _ = _clouds(5, 50)
    colors = np.random.default_rng(6).uniform(0, 1, (50, 3)) if with_colors else None
    jvis.write_pcd(str(tmp_path / "j.pcd"), pts, colors)
    tvis.write_pcd(str(tmp_path / "t.pcd"), pts, colors)
    assert _bytes(tmp_path / "j.pcd") == _bytes(tmp_path / "t.pcd")


@pytest.mark.parametrize("voxel", [0.01, 0.2])
def test_voxel_downsample(voxel):
    pts, _ = _clouds(7, 2000)
    got = tvis.voxel_downsample(pts, voxel)
    np.testing.assert_array_equal(got, jvis.voxel_downsample(pts, voxel))
    assert len(got) < 2000 if voxel == 0.2 else len(got) == 2000


def test_draw_writes_the_same_pcd(tmp_path):
    """Without open3d, draw writes the merged, coloured clouds as .pcd."""
    gt, pred = _clouds(8)
    jvis.draw([gt, pred], str(tmp_path / "j.pcd"))
    tvis.draw([gt, pred], str(tmp_path / "t.pcd"))
    assert _bytes(tmp_path / "j.pcd") == _bytes(tmp_path / "t.pcd")


def test_plots_and_lazy_matplotlib(tmp_path):
    """The plots write PNGs; importing the module imports no matplotlib."""
    pytest.importorskip("matplotlib")
    code = ("import sys, deepvcp_tpu_torch.utils.vis; "
            "sys.exit('matplotlib' in sys.modules)")
    assert subprocess.run([sys.executable, "-c", code], cwd=ROOT).returncode == 0
    kp = np.random.default_rng(9).uniform(-1, 1, (4, 3))
    cand = kp[:, None] + np.random.default_rng(10).uniform(-0.2, 0.2, (4, 27, 3))
    out = tvis.plot_voxel_candidates(kp, cand, str(tmp_path / "v.png"))
    assert os.path.getsize(out) > 0
    with open(tmp_path / "m.jsonl", "w") as fh:
        for i in range(25):
            fh.write(json.dumps({"kind": "train", "loss": 1.0 / (i + 1), "rre_deg": 5.0}) + "\n")
    out = tvis.plot_metrics(str(tmp_path / "m.jsonl"), str(tmp_path / "loss.png"))
    assert os.path.getsize(out) > 0


def test_cli_save_vis(tmp_path):
    """--eval-only --save-vis on the CPU: one .npy pair per test pair and
    vis.pcd; each pred is the Registrar's pose applied to the source, and
    vis.pcd is the last pair drawn, as the JAX CLI writes it."""
    from deepvcp_tpu_torch.data import batch_iterator
    from deepvcp_tpu_torch.ops import apply_rigid
    from deepvcp_tpu_torch.registration import Registrar
    from deepvcp_tpu_torch.train import Trainer
    from deepvcp_tpu_torch.train.cli import build_parser, configs_from_args, main, make_dataset

    common = ["--device", "cpu", "--tiny", "-d", "synthetic", "--num-points", "128",
              "--checkpoint-dir", str(tmp_path / "ck"),
              "--metrics-path", str(tmp_path / "m.jsonl")]
    main([*common, "--epochs", "1"])
    ckpt = str(tmp_path / "ck" / "final_model")
    out = str(tmp_path / "vis")
    main([*common, "--eval-only", "-r", ckpt, "--save-vis", out])
    args = build_parser().parse_args([*common, "--eval-only", "-r", ckpt])
    model_cfg, train_cfg = configs_from_args(args)
    test = make_dataset(args, model_cfg, "test")
    assert sorted(os.listdir(out)) == sorted(
        [f"{i}_{k}.npy" for i in range(len(test)) for k in ("gt", "pred")] + ["vis.pcd"])
    trainer = Trainer(model_cfg, train_cfg, device="cpu")
    trainer.setup(retrain_path=ckpt)
    reg = Registrar(model_cfg, trainer.model.state_dict(), "cpu")
    pairs = tvis.load_cloud_pairs(out)
    for i, (src, tgt, _, _) in enumerate(batch_iterator(test, 1, epoch=0,
                                                        seed=train_cfg.seed + 1, shuffle=False)):
        r = reg(torch.from_numpy(src), torch.from_numpy(tgt))
        want = apply_rigid(torch.from_numpy(src[..., :3]), r.R, r.t)[0].numpy()
        np.testing.assert_array_equal(pairs[i][1], want)
        np.testing.assert_array_equal(pairs[i][0], tgt[0, :, :3])
    jvis.draw([tgt[0, :, :3], want], str(tmp_path / "want.pcd"))
    assert _bytes(os.path.join(out, "vis.pcd")) == _bytes(tmp_path / "want.pcd")
