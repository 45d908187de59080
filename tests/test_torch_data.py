"""The port's file data and host helpers against the JAX package's on the
same files and seeds: the velodyne reader and its native binding, both
KITTIDataset routes, ModelNet40Dataset, pair construction, the rotation
helpers, and the training CLI on the file datasets. Arrays are
bit-identical unless a tolerance is stated."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from deepvcp_tpu import native as jnative
from deepvcp_tpu.data import datasets as jdatasets
from deepvcp_tpu.data import transforms as jtransforms
from deepvcp_tpu.utils import rotations as jrot
from deepvcp_tpu_torch import native as tnative
from deepvcp_tpu_torch.data import datasets as tdatasets
from deepvcp_tpu_torch.data import synthetic
from deepvcp_tpu_torch.data import transforms as ttransforms
from deepvcp_tpu_torch.utils import rotations as trot

torch.set_num_threads(2)

EULER_ATOL = 1e-4   # degrees, float32 arctan2 / arcsin of the same matrix


def _same(a, b):
    a, b = np.asarray(a), np.asarray(b)
    assert a.dtype == b.dtype and a.shape == b.shape
    np.testing.assert_array_equal(a, b)


def _same_pair(p, q):
    for field in ("src", "tgt", "R", "t"):
        _same(getattr(p, field), getattr(q, field))


def _write_kitti(root, sizes, sequences=("00", "01"), seed=0):
    """Velodyne .bin scans of the given point counts under each sequence."""
    rng = np.random.default_rng(seed)
    for seq in sequences:
        vdir = os.path.join(root, "sequences", seq, "velodyne")
        os.makedirs(vdir)
        for i, n in enumerate(sizes):
            rng.uniform(-20, 20, (n, 4)).astype(np.float32).tofile(
                os.path.join(vdir, f"{i:06d}.bin"))
    return root


def test_rotation_helpers_match_jax():
    for theta in (0.0, 0.3, -2.0):
        for name in ("rot_x", "rot_y", "rot_z"):
            _same(getattr(trot, name)(theta), getattr(jrot, name)(theta))
    _same(trot.euler_to_matrix(0.1, 0.2, 0.3), jrot.euler_to_matrix(0.1, 0.2, 0.3))
    _same(trot.axis_angle_to_matrix([1.0, 2.0, 3.0], 0.7),
          jrot.axis_angle_to_matrix([1.0, 2.0, 3.0], 0.7))
    a, b = np.random.default_rng(9), np.random.default_rng(9)
    for _ in range(3):
        _same(trot.random_rotation(a), jrot.random_rotation(b))
        _same(trot.random_bounded_rotation(a, 20.0), jrot.random_bounded_rotation(b, 20.0))
    # the synthetic module keeps no copy of its own
    assert synthetic.random_rotation is trot.random_rotation
    assert synthetic.make_pair is ttransforms.make_pair


def test_euler_metrics_match_jax():
    rng = np.random.default_rng(1)
    Ra = np.stack([jrot.random_rotation(rng) for _ in range(6)]).astype(np.float32)
    Rb = np.stack([jrot.random_bounded_rotation(rng, 30.0) for _ in range(6)]).astype(np.float32)
    np.testing.assert_allclose(trot.euler_xyz_deg(torch.from_numpy(Ra)).numpy(),
                               np.asarray(jrot.euler_xyz_deg(jnp.asarray(Ra))), atol=EULER_ATOL)
    np.testing.assert_allclose(
        trot.euler_error_deg(torch.from_numpy(Rb), torch.from_numpy(Ra)).numpy(),
        np.asarray(jrot.euler_error_deg(jnp.asarray(Rb), jnp.asarray(Ra))), atol=EULER_ATOL)


@pytest.mark.parametrize("max_rotation_deg,noise_std,normals", [
    (None, 0.0, False), (5.0, 0.01, False), (None, 0.0, True)])
def test_make_pair_and_random_pose_match_jax(max_rotation_deg, noise_std, normals):
    rng = np.random.default_rng(2)
    pts = rng.uniform(-1, 1, (50, 3))
    nrm = rng.standard_normal((50, 3)) if normals else None
    a, b = np.random.default_rng(3), np.random.default_rng(3)
    kw = dict(normals=nrm, max_translation=0.7, max_rotation_deg=max_rotation_deg,
              noise_std=noise_std)
    for x, y in zip(ttransforms.make_pair(pts, a, **kw), jtransforms.make_pair(pts, b, **kw)):
        _same(x, y)
    for x, y in zip(ttransforms.random_pose(a, 2.0, max_rotation_deg),
                    jtransforms.random_pose(b, 2.0, max_rotation_deg)):
        _same(x, y)


@pytest.mark.parametrize("n", [100, 64, 300])
def test_resample_matches_jax(n):
    pts = np.random.default_rng(4).standard_normal((100, 6))
    _same(ttransforms.resample(pts, n, np.random.default_rng(5)),
          jtransforms.resample(pts, n, np.random.default_rng(5)))


def test_velodyne_reader_and_native_binding(tmp_path):
    """The port's native library builds from native/pointcloud.cc into its
    own build directory (never into native/); its raw read gives the numpy
    reader's bytes, and its downsample the JAX binding's native one, for a
    scan longer and one shorter than n."""
    _write_kitti(str(tmp_path), [500, 10])
    path_long = str(tmp_path / "sequences" / "00" / "velodyne" / "000000.bin")
    path_short = str(tmp_path / "sequences" / "00" / "velodyne" / "000001.bin")
    raw = tdatasets.read_velodyne_bin(path_long)
    _same(raw, jdatasets.read_velodyne_bin(path_long))
    assert raw.shape == (500, 4)
    assert tnative.available() and jnative.available()
    assert os.path.dirname(tnative._build()) == tnative.BUILD_DIR
    _same(tnative.velodyne_load(path_long), raw)
    for path, n, seed in ((path_long, 256, 1), (path_short, 32, 2), (path_long, 500, 0)):
        got = tnative.velodyne_load_downsample(path, n, seed=seed)
        _same(got, jnative.velodyne_load_downsample(path, n, seed=seed))
        assert got.shape == (n, 3)
        assert np.abs(got[:, None] - np.fromfile(path, np.float32).reshape(-1, 4)[None, :, :3]
                      ).sum(-1).min(1).max() == 0.0


def test_numpy_route_matches_jax_numpy_route(tmp_path, monkeypatch):
    """Where the native library is unavailable both packages downsample with
    numpy's resample on default_rng(seed)."""
    _write_kitti(str(tmp_path), [500])
    path = str(tmp_path / "sequences" / "00" / "velodyne" / "000000.bin")
    monkeypatch.setattr(tnative, "_load", lambda: None)
    monkeypatch.setattr(jnative, "_load", lambda: None)
    assert not tnative.available()
    _same(tnative.velodyne_load(path), jnative.velodyne_load(path))
    _same(tnative.velodyne_load_downsample(path, 128, seed=7),
          jnative.velodyne_load_downsample(path, 128, seed=7))


@pytest.mark.parametrize("route", ["native", "numpy"])
@pytest.mark.parametrize("split,sequences", [("all", ("00", "01")), ("train", ("00", "01")),
                                             ("test", ("00",))])
def test_kitti_dataset_routes_match_jax(tmp_path, monkeypatch, route, split, sequences):
    """KITTIDataset through each route (native downsample with seed = the
    index; else resample with the dataset's generator), against the JAX
    dataset through the same route: files, clouds and pairs."""
    root = _write_kitti(str(tmp_path), [300, 200, 150, 90, 120])
    if route == "numpy":
        monkeypatch.setattr(tnative, "available", lambda: False)
        monkeypatch.setattr(jnative, "available", lambda: False)
    kw = dict(sequences=sequences, split=split, num_points=100, files_per_seq=5, seed=3)
    ours, theirs = tdatasets.KITTIDataset(root, **kw), jdatasets.KITTIDataset(root, **kw)
    assert ours.files == theirs.files and len(ours) == len(theirs) > 0
    for i in range(len(ours)):
        _same_pair(ours.sample(i, np.random.default_rng(i)),
                   theirs.sample(i, np.random.default_rng(i)))
    with pytest.raises(ValueError, match="split"):
        tdatasets.KITTIDataset(root, split="val")


def _write_modelnet(root, counts, seed=0):
    rng = np.random.default_rng(seed)
    names = []
    for i, n in enumerate(counts):
        cat = ("chair", "night_stand")[i % 2]
        name = f"{cat}_{i:04d}"
        os.makedirs(os.path.join(root, cat), exist_ok=True)
        nrm = rng.standard_normal((n, 3))
        data = np.concatenate([rng.uniform(-1, 1, (n, 3)),
                               nrm / np.linalg.norm(nrm, axis=-1, keepdims=True)], axis=-1)
        np.savetxt(os.path.join(root, cat, f"{name}.txt"), data, delimiter=",", fmt="%.6f")
        names.append(name)
    for split in ("train", "test"):
        with open(os.path.join(root, f"modelnet10_{split}.txt"), "w") as fh:
            fh.write("\n".join(names) + "\n")
        with open(os.path.join(root, f"modelnet10_small_{split}.txt"), "w") as fh:
            fh.write(names[0] + "\n")
    return root


@pytest.mark.parametrize("num_points,use_normal,full", [
    (None, True, True), (64, True, True), (200, False, False)])
def test_modelnet_dataset_matches_jax(tmp_path, num_points, use_normal, full):
    root = _write_modelnet(str(tmp_path), [120, 80, 150])
    kw = dict(split="train", full_dataset=full, num_points=num_points, use_normal=use_normal,
              max_translation=0.5)
    ours, theirs = tdatasets.ModelNet40Dataset(root, **kw), jdatasets.ModelNet40Dataset(root, **kw)
    assert ours.labels == theirs.labels and len(ours) == (3 if full else 1)
    for i in range(len(ours)):
        p, q = ours.sample(i, np.random.default_rng(i)), theirs.sample(i, np.random.default_rng(i))
        _same_pair(p, q)
        assert p.src.shape[-1] == (6 if use_normal else 3)


@pytest.mark.parametrize("dataset", ["kitti", "modelnet"])
def test_train_cli_on_file_datasets(tmp_path, dataset):
    """python -m deepvcp_tpu_torch.train -d kitti|modelnet --root ... --tiny
    on written files: one epoch on the CPU and a final checkpoint."""
    from deepvcp_tpu_torch.train.cli import main

    root = str(tmp_path / "data")
    if dataset == "kitti":
        # the CLI's default sequences: train on 00-02, test on 03
        _write_kitti(root, [200] * 2, sequences=("00", "01", "02", "03"))
    else:
        _write_modelnet(root, [100, 90, 110])
    ck = str(tmp_path / "ck")
    main(["--device", "cpu", "--tiny", "-d", dataset, "--root", root, "--num-points", "64",
          "--epochs", "1", "--checkpoint-dir", ck, "--metrics-path",
          str(tmp_path / "m.jsonl")])
    assert os.path.exists(os.path.join(ck, "final_model"))
