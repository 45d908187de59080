"""The Kabsch solve's SVD of [..., 3, 3] matrices, with no host sync on the card.

On a CUDA tensor torch.linalg.svd of matrices no larger than 32 x 32 runs
cuSOLVER's batched Jacobi SVD (`cusolverDn{S,D}gesvdjBatched`) on a
column-major copy of its input, then copies every matrix's convergence
`info` to pageable host memory (re-running through `gesvd` any matrix that
did not converge) and reads it once more to raise on an error: two host
syncs a call, in which the host waits for all the work queued before it.

`gesvdj_batched` makes the same cuSOLVER call without either readback: the
same routine of the cuSOLVER library that torch has loaded in this process
(not another copy), on the same column-major copy, with torch's parameters
(the dtype's machine epsilon as the tolerance, sorted singular values), on
torch's current stream, and returns U, S and Vh with the strides that
torch.linalg.svd returns, so the products after it pick the same kernels.
U, S and Vh are torch.linalg.svd's bits. `info` stays on the device: a
matrix that gesvdj leaves unconverged keeps its last Jacobi iterate, as
JAX's `jnp.linalg.svd` (which has neither a fallback nor an error) does,
where torch re-runs it through `gesvd` or raises. The handle and the gesvdj
parameters are made once per card; the workspace and `info` come from
torch's allocator. It replaces no TPU kernel: the JAX package calls XLA's SVD.

`svd` is the route: `gesvdj_batched` where `applies` holds (a CUDA tensor of
shape [..., 3, 3] in f32 or f64, outside `reference_path()`, and no gradient
to record), else torch.linalg.svd: on the CPU, under `reference_path()`, and
where autograd records the SVD (training backpropagates through it).
"""

from __future__ import annotations

import ctypes
import os
import re
import threading
from typing import Tuple

import torch

from deepvcp_tpu_torch.ops.kernels import _plain

_EIG_MODE_VECTOR = 1   # cusolverEigMode_t CUSOLVER_EIG_MODE_VECTOR: U and V too
_LIBRARY = re.compile(r"/libcusolver\.so[.0-9]*$")
_ROUTINES = {torch.float32: "S", torch.float64: "D"}

_lock = threading.Lock()
_lib = None
_solvers = {}   # (card index, dtype) -> (cusolverDnHandle_t, gesvdjInfo_t)


def on_card(t: torch.Tensor) -> bool:
    """Whether t lies on a CUDA card (the CPU tests stand in for one here)."""
    return t.is_cuda


def applies(H: torch.Tensor) -> bool:
    """Whether `svd` takes H's SVD through gesvdj_batched."""
    return (on_card(H) and not _plain.active() and H.dim() >= 2 and H.shape[-2:] == (3, 3)
            and H.dtype in _ROUTINES and H.numel() > 0
            and not (torch.is_grad_enabled() and H.requires_grad))


def svd(H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torch.linalg.svd(H) -> (U, S, Vh), through gesvdj_batched where
    `applies` holds."""
    return gesvdj_batched(H) if applies(H) else torch.linalg.svd(H)


def _loaded_cusolver() -> str:
    with open("/proc/self/maps") as fh:
        for line in fh:
            path = line.split(None, 5)[-1].strip()
            if _LIBRARY.search(path):
                return path
    return ""


def _library() -> ctypes.CDLL:
    """The cuSOLVER library that torch has loaded, with the entry points
    declared."""
    global _lib
    if _lib is None:
        path = _loaded_cusolver()
        if not path:
            raise RuntimeError("torch has loaded no libcusolver: its SVD does not run on cuSOLVER")
        lib = ctypes.CDLL(path, mode=os.RTLD_NOLOAD)
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.cusolverDnCreate.argtypes = [p]
        lib.cusolverDnSetStream.argtypes = [p, p]
        lib.cusolverDnCreateGesvdjInfo.argtypes = [p]
        lib.cusolverDnXgesvdjSetTolerance.argtypes = [p, ctypes.c_double]
        lib.cusolverDnXgesvdjSetSortEig.argtypes = [p, i]
        for r in _ROUTINES.values():
            getattr(lib, f"cusolverDn{r}gesvdjBatched_bufferSize").argtypes = [
                p, i, i, i, p, i, p, p, i, p, i, p, p, i]
            getattr(lib, f"cusolverDn{r}gesvdjBatched").argtypes = [
                p, i, i, i, p, i, p, p, i, p, i, p, i, p, p, i]
        _lib = lib
    return _lib


def _check(status: int, what: str) -> None:
    if status != 0:
        raise RuntimeError(f"{what} returned cusolverStatus_t {status}")


def _solver(device: torch.device, dtype: torch.dtype):
    """The card's cuSOLVER handle and gesvdj parameters for dtype, made on
    first use. Those that give torch.linalg.svd's bits, found by comparing
    them on the card (PERF.md, H1): the tolerance the dtype's machine
    epsilon (cuSOLVER's default differs in ~1% of the elements), singular
    values sorted. The most sweeps changes no matrix that converges (15,
    100 and 400 read alike), so cuSOLVER's default stays."""
    key = (device.index, dtype)
    if key not in _solvers:
        lib = _library()
        handle, params = ctypes.c_void_p(), ctypes.c_void_p()
        with torch.cuda.device(device.index):
            _check(lib.cusolverDnCreate(ctypes.byref(handle)), "cusolverDnCreate")
        _check(lib.cusolverDnCreateGesvdjInfo(ctypes.byref(params)), "cusolverDnCreateGesvdjInfo")
        _check(lib.cusolverDnXgesvdjSetTolerance(params, torch.finfo(dtype).eps),
               "cusolverDnXgesvdjSetTolerance")
        _check(lib.cusolverDnXgesvdjSetSortEig(params, 1), "cusolverDnXgesvdjSetSortEig")
        _solvers[key] = (handle, params)
    return _solvers[key]


def gesvdj_batched(H: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """torch.linalg.svd(H)'s U, S and Vh, bit for bit, for a CUDA tensor H
    [..., 3, 3] in f32 or f64, with no host sync: cuSOLVER's
    gesvdjBatched on torch's current stream, `info` left on the device.
    Records no autograd graph. `gesvdj_batched.launches` counts the calls,
    `gesvdj_batched.info` is the last call's info ([...] int32: 0 where
    gesvdj converged, cuSOLVER's min(m, n) + 1 = 4 where it kept the last
    Jacobi iterate); nothing reads it."""
    if not (on_card(H) and H.dim() >= 2 and H.shape[-2:] == (3, 3) and H.dtype in _ROUTINES
            and H.numel() > 0):
        raise ValueError(f"a CUDA tensor [..., 3, 3] of f32 or f64 with a batch, got "
                         f"{tuple(H.shape)} {H.dtype} on {H.device}")
    index = H.get_device()
    if index != torch._C._cuda_getDevice():   # cuSOLVER launches on the current card
        with torch.cuda.device(index):
            return gesvdj_batched(H)
    with _lock:   # one handle a card: its stream is set for this call
        batch, dtype = H.shape[:-2], H.dtype
        handle, params = _solver(H.device, dtype)
        count = H.numel() // 9
        # the column-major copy gesvdj overwrites; U and V column-major too,
        # V being Vh row-major: torch.linalg.svd's buffers and strides
        a = H.detach().mT.clone(memory_format=torch.contiguous_format)
        u = torch.empty(batch + (3, 3), dtype=dtype, device=H.device)
        s = torch.empty(batch + (3,), dtype=dtype, device=H.device)
        vh = torch.empty(batch + (3, 3), dtype=dtype, device=H.device)
        info = torch.zeros(batch, dtype=torch.int32, device=H.device)
        r = _ROUTINES[dtype]
        ptrs = (a.data_ptr(), 3, s.data_ptr(), u.data_ptr(), 3, vh.data_ptr(), 3)
        lwork = ctypes.c_int()
        _check(getattr(_lib, f"cusolverDn{r}gesvdjBatched_bufferSize")(
            handle, _EIG_MODE_VECTOR, 3, 3, *ptrs, ctypes.byref(lwork), params, count),
            f"cusolverDn{r}gesvdjBatched_bufferSize")
        work = torch.empty(lwork.value, dtype=dtype, device=H.device)
        _check(_lib.cusolverDnSetStream(handle, torch._C._cuda_getCurrentRawStream(index)),
               "cusolverDnSetStream")
        _check(getattr(_lib, f"cusolverDn{r}gesvdjBatched")(
            handle, _EIG_MODE_VECTOR, 3, 3, *ptrs, work.data_ptr(), lwork.value,
            info.data_ptr(), params, count), f"cusolverDn{r}gesvdjBatched")
    gesvdj_batched.launches += 1
    gesvdj_batched.info = info
    return u.mT, s, vh


gesvdj_batched.launches = 0
gesvdj_batched.info = None
