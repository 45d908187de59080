"""File datasets without JAX (counterpart of deepvcp_tpu/data/datasets.py:
RegistrationPair, ModelNet40Dataset, read_velodyne_bin, KITTIDataset).

Host-side numpy pipelines: each dataset has `__len__` and
`sample(index, rng) -> RegistrationPair`, and data.batch_iterator stacks
samples into [B, N, C] batches. The same files and seeds give the JAX
package's arrays bit for bit.
"""

from __future__ import annotations

import os
from typing import List, NamedTuple, Optional, Sequence

import numpy as np

from deepvcp_tpu_torch.data.transforms import make_pair, resample


class RegistrationPair(NamedTuple):
    src: np.ndarray   # [N, 3 or 6]
    tgt: np.ndarray   # [N, 3 or 6]
    R: np.ndarray     # [3, 3]
    t: np.ndarray     # [3]


class ModelNet40Dataset:
    """ModelNet40's 'normal_resampled' layout: the root holds
    `modelnet10_{split}.txt` (or `modelnet10_small_{split}.txt` when
    full_dataset is False) listing names, and `<category>/<name>.txt` CSVs
    of x,y,z,nx,ny,nz rows. Clouds load eagerly; pairs are made on the fly
    with a random pose."""

    def __init__(self, root: str, split: str = "train", full_dataset: bool = True,
                 num_points: Optional[int] = None, use_normal: bool = True,
                 max_translation: float = 1.0):
        self.root = root
        self.use_normal = use_normal
        self.num_points = num_points
        self.max_translation = max_translation
        list_name = f"modelnet10_{split}.txt" if full_dataset else f"modelnet10_small_{split}.txt"
        names = np.loadtxt(os.path.join(root, list_name), dtype=str).reshape(-1)
        self.points: List[np.ndarray] = []
        self.normals: List[np.ndarray] = []
        self.labels: List[str] = []
        for name in names:
            category = str(name).rsplit("_", 1)[0]
            data = np.loadtxt(os.path.join(root, category, f"{name}.txt"), delimiter=",",
                              dtype=np.float64)
            self.points.append(data[:, :3])
            self.normals.append(data[:, 3:6])
            self.labels.append(str(name))

    def __len__(self) -> int:
        return len(self.points)

    def sample(self, index: int, rng: np.random.Generator) -> RegistrationPair:
        pts, nrm = self.points[index], self.normals[index]
        if self.num_points is not None and pts.shape[0] != self.num_points:
            both = resample(np.concatenate([pts, nrm], axis=-1), self.num_points, rng)
            pts, nrm = both[:, :3], both[:, 3:]
        return RegistrationPair(*make_pair(pts, rng, normals=nrm if self.use_normal else None,
                                           max_translation=self.max_translation))


def read_velodyne_bin(path: str) -> np.ndarray:
    """A KITTI velodyne scan: float32 [N, 4] (x, y, z, reflectance)."""
    return np.fromfile(path, dtype=np.float32).reshape(-1, 4)


class KITTIDataset:
    """KITTI odometry velodyne scans under `root/sequences/<seq>/velodyne/*.bin`,
    each downsampled to num_points, with pairs made by a random pose (the
    consecutive-frame pairs are odometry's). `files_per_seq` caps the scans
    of each sequence (None: all).

    split: "all" takes every scan; "train"/"test" over two or more
    sequences split by sequence (test is the last); over one sequence they
    split its scans 80/20.

    A scan is downsampled natively (native.velodyne_load_downsample with
    seed = its index) where the native library is available, else by
    `resample` with the dataset's own generator (seeded by `seed`), as in
    the JAX package: the two routes sample differently."""

    def __init__(self, root: str, sequences: Sequence[str] = ("00", "01", "02", "03"),
                 split: str = "all", num_points: int = 10000,
                 files_per_seq: Optional[int] = 50, max_translation: float = 1.0,
                 eager: bool = False, seed: int = 0):
        if split not in ("all", "train", "test"):
            raise ValueError(f"split must be all/train/test, got {split!r}")
        self.root = root
        self.split = split
        self.num_points = num_points
        self.max_translation = max_translation
        scan_split = split != "all" and len(sequences) == 1
        if split != "all" and len(sequences) > 1:
            sequences = tuple(sequences[:-1]) if split == "train" else (sequences[-1],)
        self.sequences = tuple(sequences)
        self.files: List[str] = []
        for seq in self.sequences:
            vdir = os.path.join(root, "sequences", seq, "velodyne")
            names = sorted(os.listdir(vdir))[:files_per_seq]
            if scan_split:
                cut = max(int(len(names) * 0.8), 1)
                names = names[:cut] if split == "train" else names[cut:]
            self.files.extend(os.path.join(vdir, n) for n in names)
        if not self.files:
            raise ValueError(
                f"KITTIDataset split={split!r} over sequences {self.sequences} selected "
                f"zero scans (too few files for a scan-based split?)")
        self._cache: dict = {}
        self._downsample_rng = np.random.default_rng(seed)
        if eager:
            for i in range(len(self.files)):
                self._load(i)

    def _load(self, index: int) -> np.ndarray:
        if index not in self._cache:
            from deepvcp_tpu_torch import native

            if native.available():
                self._cache[index] = native.velodyne_load_downsample(
                    self.files[index], self.num_points, seed=index).astype(np.float64)
            else:
                scan = read_velodyne_bin(self.files[index])
                self._cache[index] = resample(scan[:, :3].astype(np.float64), self.num_points,
                                              self._downsample_rng)
        return self._cache[index]

    def __len__(self) -> int:
        return len(self.files)

    def sample(self, index: int, rng: np.random.Generator) -> RegistrationPair:
        return RegistrationPair(*make_pair(self._load(index), rng, normals=None,
                                           max_translation=self.max_translation))
