"""Build the port's CUDA sources with nvcc and load them with ctypes.

Every `csrc/*.cu` file is compiled, one nvcc process each and all at once
(a build takes the slowest source's time, not the sum, as kernels are
added), then linked into one shared library with a plain C interface (no PyTorch
headers, so a build takes seconds), for Hopper's `sm_90a`. The library lands
in `deepvcp_tpu_torch/_build/` under a name keyed by a hash of the sources,
the headers beside them and the flags, so an edited source is rebuilt and
an unchanged one is loaded as it is. Nothing here runs at import time: the first
call to `library()` builds, and it is made only by a wrapper that was handed
a CUDA tensor.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading

import torch

_PKG = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
)

_lock = threading.Lock()
_lib = None


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found on PATH or under $CUDA_HOME/bin: the port's CUDA "
        "kernels are built from source on first use")


def _sources() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def _headers() -> list:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _digest(sources) -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sources:
        h.update(os.path.basename(path).encode())
        with open(path, "rb") as fh:
            h.update(fh.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile csrc/*.cu into BUILD_DIR (if not already built); return the
    library's path. Raises RuntimeError with nvcc's stderr on failure."""
    sources = _sources()
    if not sources:
        raise RuntimeError(f"no CUDA sources under {CSRC}")
    target = os.path.join(BUILD_DIR, f"libdeepvcp_kernels_{_digest(sources + _headers())}.so")
    if os.path.exists(target):
        return target
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmpdir:
        objs = [os.path.join(tmpdir, os.path.basename(src) + ".o") for src in sources]
        jobs = [([nvcc, *NVCC_FLAGS, "-c", "-o", obj, src]) for src, obj in zip(sources, objs)]
        procs = [subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
                 for cmd in jobs]
        results = [proc.communicate() for proc in procs]
        for cmd, proc, (_, err) in zip(jobs, procs, results):
            if proc.returncode != 0:
                raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{err}")
        tmp = os.path.join(tmpdir, "lib.so")
        cmd = [nvcc, *NVCC_FLAGS, "-shared", "-o", tmp, *objs]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}): {' '.join(cmd)}\n{proc.stderr}")
        os.replace(tmp, target)  # atomic: a reader never sees a partial file
    return target


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use, with every entry
    point's argtypes and restype declared."""
    global _lib
    if _lib is not None:  # the wrappers' path: no lock once loaded
        return _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
            lib.band_max_f32.argtypes = [p, p, p, i, i, i, f, f, p]
            lib.band_max_f32.restype = i
            lib.band_max_grad_f32.argtypes = [p, p, p, p, p, i, i, i, f, f, p]
            lib.band_max_grad_f32.restype = i
            lib.fps_f32.argtypes = [p, p, p, i, i, i, i, i, p]
            lib.fps_f32.restype = i
            lib.fps_pick_probe.argtypes = [i, i, i, i, p, p]
            lib.fps_pick_probe.restype = i
            lib.onehot_gather_f32.argtypes = [p, p, p, i, i, i, i, p]
            lib.onehot_gather_f32.restype = i
            lib.onehot_scatter_add_f32.argtypes = [p, p, p, i, i, i, i, p]
            lib.onehot_scatter_add_f32.restype = i
            lib.knn_select_f32.argtypes = [p, p, p, p, p, p, i, i, i, i, p]
            lib.knn_select_f32.restype = i
            lib.band_max_error_string.argtypes = [i]
            lib.band_max_error_string.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def launch(fn, t, *args) -> None:
    """fn(*args, stream): one kernel of the library on the card of tensor t
    and that card's current stream; raises with CUDA's message if fn
    returns an error code. The host's time here is the caller's (the
    paths wait on the host): the stream is read as a raw handle, and the
    current card is switched only when t lies on another."""
    index = t.get_device()
    if index != torch._C._cuda_getDevice():
        with torch.cuda.device(index):
            return launch(fn, t, *args)
    rc = fn(*args, torch._C._cuda_getCurrentRawStream(index))
    if rc != 0:
        raise RuntimeError(f"{fn.__name__} launch failed: "
                           f"{library().band_max_error_string(rc).decode()}")
