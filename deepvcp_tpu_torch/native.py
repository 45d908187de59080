"""The port's own ctypes binding of the native host runtime,
native/pointcloud.cc (counterpart of deepvcp_tpu/native.py: velodyne_load,
velodyne_load_downsample).

The library is built on first use with `g++ -O3 -shared -fPIC` from the
in-tree source into deepvcp_tpu_torch/_build/, under a name keyed by a
hash of the source and the flags; nothing is written under native/. As in
the JAX package, the native library is optional: where it cannot be built
or loaded, each entry point reads with numpy instead. `available()` says
which route is taken. This is host I/O ahead of the device path.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
SOURCE = os.path.join(os.path.dirname(_PKG), "native", "pointcloud.cc")
BUILD_DIR = os.path.join(_PKG, "_build")
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")

_f32p = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")

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
    be built or loaded (then every entry point reads with numpy)."""
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
