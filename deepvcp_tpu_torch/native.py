"""The port's own ctypes binding of the native host runtime,
native/pointcloud.cc (counterpart of deepvcp_tpu/native.py): the velodyne
readers (velodyne_load, velodyne_load_downsample) and the host geometry
oracles (knn, farthest_point_sample, query_ball_point, make_pair) that the
device ops are held against.

The library is built on first use with g++ and CXX_FLAGS from the in-tree
source into deepvcp_tpu_torch/_build/, under a name keyed by a hash of the
source and the flags; nothing is written under native/. As in the JAX
package, the native library is optional: where it cannot be built or
loaded, each entry point computes with numpy instead. `available()` says
which route is taken.

The flags differ from native/build.sh's (`-march=native -fopenmp`) on
purpose:
- `-ffp-contract=off`: a squared distance is ((dx*dx) + (dy*dy)) + (dz*dz),
  each step rounded to f32, as kernel K3 (csrc/fps.cu, `__f*_rn`) and the
  numpy routes compute it. With FMA contraction (GCC's default where the
  target has FMA, e.g. under -march=native) the oracle's distances move
  by an ulp and FPS near-ties flip, so K3 could not be held to its
  indices exactly.
- no `-fopenmp`: the `#pragma omp` loops run serially. Every query row is
  computed on its own, so the results are the same either way; the oracles
  are references, not a hot path, and a serial build needs no OpenMP
  runtime and spawns no thread pool inside test workers.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional, Tuple

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "pointcloud.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-ffp-contract=off")
_KNN_CHUNK = 256   # queries a step of knn's numpy route: a [256, N, 3] f32 block

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_i32p = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None
_tried = False


def _build() -> Optional[str]:
    """Compile SOURCE into BUILD_DIR unless built already; the library's
    path, or None where there is no source or no working g++."""
    cxx = shutil.which("g++")
    if cxx is None or not os.path.exists(SOURCE):
        return None
    with open(SOURCE, "rb") as fh:
        digest = hashlib.sha256(fh.read() + " ".join(CXX_FLAGS).encode()).hexdigest()[:16]
    target = os.path.join(BUILD_DIR, f"libdeepvcp_native_{digest}.so")
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        tmp = os.path.join(tmpdir, "lib.so")
        try:
            proc = subprocess.run([cxx, *CXX_FLAGS, SOURCE, "-o", tmp],
                                  capture_output=True, timeout=120)
        except (OSError, subprocess.TimeoutExpired):
            return None
        if proc.returncode != 0:
            return None
        os.replace(tmp, target)  # atomic: a concurrent reader never sees a partial file
    return target


def _load() -> Optional[ctypes.CDLL]:
    """The loaded library, built on the first call; None where it cannot
    be built or loaded (then every entry point computes with numpy)."""
    global _lib, _tried
    with _lock:
        if not _tried:
            _tried = True
            path = _build()
            if path is not None:
                try:
                    lib = ctypes.CDLL(path)
                except OSError:
                    lib = None
                if lib is not None:
                    lib.velodyne_num_points.restype = ctypes.c_int64
                    lib.velodyne_num_points.argtypes = [ctypes.c_char_p]
                    lib.velodyne_read.restype = ctypes.c_int64
                    lib.velodyne_read.argtypes = [ctypes.c_char_p, _f32p, ctypes.c_int64]
                    lib.velodyne_load_downsample.restype = ctypes.c_int
                    lib.velodyne_load_downsample.argtypes = [
                        ctypes.c_char_p, ctypes.c_int64, ctypes.c_uint64, _f32p]
                    lib.knn_bruteforce.restype = None
                    lib.knn_bruteforce.argtypes = [
                        _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_int64,
                        _f32p, _i32p]
                    lib.farthest_point_sample.restype = None
                    lib.farthest_point_sample.argtypes = [
                        _f32p, ctypes.c_int64, ctypes.c_int64, ctypes.c_int64, _i32p]
                    lib.query_ball_point.restype = None
                    lib.query_ball_point.argtypes = [
                        _f32p, ctypes.c_int64, _f32p, ctypes.c_int64, ctypes.c_float,
                        ctypes.c_int64, _i32p]
                    lib.make_pair.restype = None
                    lib.make_pair.argtypes = [
                        _f32p, ctypes.c_int64, ctypes.c_uint64, ctypes.c_float,
                        _f32p, _f32p, _f32p]
                    _lib = lib
        return _lib


def available() -> bool:
    """Whether the native library is built and loaded (the native route)."""
    return _load() is not None


def velodyne_load(path: str) -> np.ndarray:
    """Raw [N, 4] float32 scan (x, y, z, reflectance), read natively when
    the library is available; the numpy reader gives the same bytes."""
    lib = _load()
    if lib is not None:
        n = lib.velodyne_num_points(path.encode())
        if n >= 0:
            out = np.empty((n, 4), np.float32)
            if lib.velodyne_read(path.encode(), out, n) == n:
                return out
    from deepvcp_tpu_torch.data.datasets import read_velodyne_bin

    return read_velodyne_bin(path)


def velodyne_load_downsample(path: str, n: int, seed: int = 0) -> np.ndarray:
    """[n, 3] float32 xyz of a KITTI velodyne .bin, downsampled to n points
    (without replacement when the scan has n or more; deterministic in
    seed). Natively when the library is available, else with numpy's
    `resample` on default_rng(seed), as the JAX package does: the two
    routes sample differently."""
    lib = _load()
    if lib is not None:
        out = np.empty((n, 3), np.float32)
        if lib.velodyne_load_downsample(path.encode(), n, seed & (2**64 - 1), out) == 0:
            return out
    from deepvcp_tpu_torch.data.datasets import read_velodyne_bin
    from deepvcp_tpu_torch.data.transforms import resample

    scan = read_velodyne_bin(path)[:, :3]
    return resample(scan, n, np.random.default_rng(seed)).astype(np.float32)


def _points(x: np.ndarray, what: str) -> np.ndarray:
    """x as a C-contiguous f32 [n, 3] array; raises on another shape (the
    library reads rows of 3 floats)."""
    x = np.ascontiguousarray(x, np.float32)
    if x.ndim != 2 or x.shape[1] != 3:
        raise ValueError(f"{what} must be [n, 3], got {list(x.shape)}")
    return x


def _squared_distances(points: np.ndarray, queries: np.ndarray) -> np.ndarray:
    """[S, N] f32 squared distances, ((dx*dx) + (dy*dy)) + (dz*dz) rounded
    step by step as the native build computes them."""
    d = points[None, :, :] - queries[:, None, :]
    d = d * d
    return (d[..., 0] + d[..., 1]) + d[..., 2]


def knn(ref: np.ndarray, query: np.ndarray, k: int) -> Tuple[np.ndarray, np.ndarray]:
    """Exact brute-force KNN: ref [N, 3], query [M, 3] -> (dist [M, k] f32
    ascending euclidean distances, idx [M, k] int32). Each row holds the k
    smallest (squared distance, index) pairs in that order, so a tie at
    the k-th distance keeps the lower index. The numpy route computes
    _KNN_CHUNK queries at a time."""
    ref, query = _points(ref, "ref"), _points(query, "query")
    if not 1 <= k <= ref.shape[0]:
        raise ValueError(f"k must be in [1, {ref.shape[0]}], got {k}")
    lib = _load()
    if lib is not None:
        dist = np.empty((query.shape[0], k), np.float32)
        idx = np.empty((query.shape[0], k), np.int32)
        lib.knn_bruteforce(ref, ref.shape[0], query, query.shape[0], k, dist, idx)
        return dist, idx
    dist = np.empty((query.shape[0], k), np.float32)
    idx = np.empty((query.shape[0], k), np.int32)
    for lo in range(0, query.shape[0], _KNN_CHUNK):
        d2 = _squared_distances(ref, query[lo:lo + _KNN_CHUNK])
        order = np.argsort(d2, axis=-1, kind="stable")[:, :k]
        idx[lo:lo + _KNN_CHUNK] = order
        dist[lo:lo + _KNN_CHUNK] = np.sqrt(np.take_along_axis(d2, order, -1))
    return dist, idx


def farthest_point_sample(xyz: np.ndarray, npoint: int, start_idx: int = 0) -> np.ndarray:
    """Farthest-point sampling of xyz [N, 3] from start_idx -> [npoint]
    int32: each pick is the point farthest from those picked so far (the
    running minimum of squared distances), the lowest index on a tie."""
    xyz = _points(xyz, "xyz")
    if not 0 <= start_idx < xyz.shape[0]:
        raise ValueError(f"start_idx must be in [0, {xyz.shape[0]}), got {start_idx}")
    lib = _load()
    if lib is not None:
        out = np.empty(npoint, np.int32)
        lib.farthest_point_sample(xyz, xyz.shape[0], npoint, start_idx, out)
        return out
    dist = np.full(xyz.shape[0], 1e30, np.float32)
    far = start_idx
    out = np.empty(npoint, np.int32)
    for i in range(npoint):
        out[i] = far
        dist = np.minimum(dist, _squared_distances(xyz, xyz[far:far + 1])[0])
        far = int(np.argmax(dist))
    return out


def query_ball_point(xyz: np.ndarray, queries: np.ndarray, radius: float,
                     nsample: int) -> np.ndarray:
    """Ball query with the reference's semantics: for each query [S, 3] the
    first nsample points of xyz [N, 3] within radius (squared distance <=
    the f32 radius squared), in index order, padded with the first hit (N
    - 1 where there is none) -> [S, nsample] int32."""
    xyz, queries = _points(xyz, "xyz"), _points(queries, "queries")
    lib = _load()
    out = np.empty((queries.shape[0], nsample), np.int32)
    if lib is not None:
        lib.query_ball_point(xyz, xyz.shape[0], queries, queries.shape[0], radius, nsample, out)
        return out
    r2 = np.float32(radius) * np.float32(radius)
    for q, d2 in enumerate(_squared_distances(xyz, queries)):
        hits = np.nonzero(d2 <= r2)[0][:nsample]
        out[q] = hits[0] if len(hits) else xyz.shape[0] - 1
        out[q, :len(hits)] = hits
    return out


def make_pair(src: np.ndarray, seed: int, max_translation: float = 1.0
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """A random-pose pair of src [N, 3]: (tgt = src @ R.T + t [N, 3], R
    [3, 3], t [3]), all f32, deterministic in seed. Natively R = Rx Ry Rz of
    uniform angles and t uniform in [-max_translation, max_translation]^3
    from mt19937_64(seed); else data.transforms.make_pair on
    default_rng(seed), as the JAX package does: the two routes draw
    different poses."""
    src = _points(src, "src")
    lib = _load()
    if lib is not None:
        tgt = np.empty_like(src)
        R = np.empty(9, np.float32)
        t = np.empty(3, np.float32)
        lib.make_pair(src, src.shape[0], seed & (2**64 - 1), max_translation, tgt, R, t)
        return tgt, R.reshape(3, 3), t
    from deepvcp_tpu_torch.data.transforms import make_pair as _pair

    _, tgt, R, t = _pair(src, np.random.default_rng(seed), max_translation=max_translation)
    return tgt, R, t
