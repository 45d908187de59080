"""Kernels K1 and K2: banded masked max-pool over an x-sorted cloud, and its
backward.

    K1  pooled[b, q, c] = max over n with |x_n - x_q|^2 <= r^2 of u[b, n, c]
    K2  grad_u[b, n, c] = sum over q with |x_n - x_q|^2 <= r^2 of
                          g[b, q, c] * [u[b, n, c] == pooled[b, q, c]]

The inner loop of every banded set-abstraction stage (models/fused_sa.py),
forward and backward. On a CUDA tensor `banded_masked_max` launches the
hand-written Hopper kernel in `csrc/band_max.cu` (replacing the TPU kernel
`deepvcp_tpu/ops/pallas/band_max_kernel.py::banded_masked_max`) and
`banded_masked_max_grad` the one in `csrc/band_max_grad.cu` (replacing
`banded_masked_max_grad` of the same file); on a CPU tensor each runs its
plain PyTorch version (`*_reference`). K1 is bit-identical to its plain
version (see the source note in band_max.cu); K2 sums in another order, so it
is bit-identical where the sums are exact (integer-valued cotangents) and
within f32 rounding otherwise. Every point tied at a query's max receives
the query's full cotangent, as in the TPU kernel: this is not
`torch.amax`'s backward, which splits it among the ties.

Semantics: the EXACT in-radius set, with no cap on the number of neighbours,
which is what the TPU kernel computed and what the checkpoints were trained
under. The JAX model on CPU computes something else: its SA stages run
`xla_banded_max` (deepvcp_tpu/models/fused_sa.py), a static torus-rolled band
of `window_for(N, r, extent, safety)` sorted positions per side. The two
agree only when that band covers the whole slab, i.e. when
`window_for(...) >= N`, as at `DeepVCPConfig.tiny()`. So the port is held
against the JAX model at such tiny configs, and against the Pallas kernel in
interpret mode for its own semantics.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from deepvcp_tpu_torch.ops.kernels import _plain

NEG = -1e30
SUPPORTED_CHANNELS = (16, 32, 64)  # the SA stages' first widths
_REFERENCE_CHUNK = 64  # queries (K1) or receivers (K2) per [B, chunk, N, C] block


def radius_squared(radius: float) -> float:
    """r^2 rounded once to f32, the threshold both versions compare with."""
    return float(np.float32(float(radius) ** 2))


@torch.no_grad()
def banded_masked_max_reference(
    sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float
) -> torch.Tensor:
    """Plain PyTorch exact in-radius masked max over the whole cloud,
    chunked over queries so that a [B, 64, N, C] block bounds memory.

    sorted_xyz [B, N, 3], u [B, N, C] float32 -> [B, N, C] float32; rows with
    no point in radius get -1e30. Does not use the sort: it is the
    definition the kernel's slab search must reproduce. Like the kernel, it
    records no autograd graph: models/fused_sa.py::banded_max_pool is the
    differentiable op."""
    r2 = radius_squared(radius)
    out = torch.empty_like(u)
    chunk = _REFERENCE_CHUNK
    for s in range(0, sorted_xyz.shape[1], chunk):
        q = sorted_xyz[:, s:s + chunk]
        d = sorted_xyz[:, None, :, :] - q[:, :, None, :]     # [B, m, N, 3]
        # ((dx*dx) + (dy*dy)) + (dz*dz): the kernel's exact f32 expression
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        masked = torch.where((d2 <= r2)[..., None], u[:, None, :, :], NEG)
        out[:, s:s + chunk] = masked.amax(dim=2)
    return out


@torch.no_grad()
def banded_masked_max_grad_reference(
    sorted_xyz: torch.Tensor, u: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """Plain PyTorch VJP of the exact in-radius masked max with respect to u,
    chunked over receivers so that a [B, 64, N, C] block bounds memory.

    sorted_xyz [B, N, 3]; u (forward input), out (forward output) and g
    (cotangent of out) [B, N, C] float32 -> grad_u [B, N, C] float32:
    grad_u[n, c] = sum over in-radius q of g[q, c] * [u[n, c] == out[q, c]],
    the indicator sum written out, so every tie gets the full cotangent."""
    r2 = radius_squared(radius)
    grad = torch.empty_like(u)
    chunk = _REFERENCE_CHUNK
    for s in range(0, sorted_xyz.shape[1], chunk):
        n = sorted_xyz[:, s:s + chunk]
        d = sorted_xyz[:, None, :, :] - n[:, :, None, :]     # [B, m, N, 3]
        # ((dx*dx) + (dy*dy)) + (dz*dz): K1's f32 expression, so the two
        # directions accept the same pairs
        d2 = (d[..., 0] * d[..., 0] + d[..., 1] * d[..., 1]) + d[..., 2] * d[..., 2]
        took = (d2 <= r2)[..., None] & (u[:, s:s + chunk, None, :] == out[:, None, :, :])
        grad[:, s:s + chunk] = torch.where(took, g[:, None, :, :], 0.0).sum(dim=2)
    return grad


def _check(sorted_xyz: torch.Tensor, *feats: torch.Tensor) -> None:
    if sorted_xyz.dim() != 3 or sorted_xyz.shape[-1] != 3:
        raise ValueError(f"sorted_xyz must be [B, N, 3], got {tuple(sorted_xyz.shape)}")
    for u in feats:
        if u.dim() != 3 or u.shape[:2] != sorted_xyz.shape[:2] or u.shape != feats[0].shape:
            raise ValueError(
                f"features must be [B, N, C] matching sorted_xyz "
                f"{tuple(sorted_xyz.shape)} and each other, got {tuple(u.shape)}")
        if u.dtype != torch.float32:
            raise TypeError(f"float32 only, got {u.dtype}")
        if u.device != sorted_xyz.device:
            raise ValueError(f"tensors on {sorted_xyz.device} and {u.device}")
    if sorted_xyz.dtype != torch.float32:
        raise TypeError(f"float32 only, got {sorted_xyz.dtype}")


def _kernel_args(sorted_xyz: torch.Tensor, *feats: torch.Tensor) -> None:
    """Raise unless the CUDA kernels take these tensors as they are."""
    if sorted_xyz.device.type != "cuda":
        raise ValueError(f"no kernel for device {sorted_xyz.device}")
    C = feats[0].shape[-1]
    if C not in SUPPORTED_CHANNELS:
        raise ValueError(f"C={C} not in the kernel's {SUPPORTED_CHANNELS}")
    if not all(t.is_contiguous() for t in (sorted_xyz, *feats)):
        raise ValueError("the band-max kernels need contiguous inputs")


def banded_masked_max(
    sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float
) -> torch.Tensor:
    """pooled[b, q, c] = max over n with |x_n - x_q| <= radius of u[b, n, c].

    sorted_xyz [B, N, 3] sorted ascending by x, u [B, N, C], both float32
    -> [B, N, C] float32. A CPU tensor runs the plain reference; a CUDA
    tensor launches the Hopper kernel (C in SUPPORTED_CHANNELS, contiguous
    inputs) or raises. `banded_masked_max.launches` counts kernel launches."""
    _check(sorted_xyz, u)
    if sorted_xyz.device.type == "cpu" or _plain.active():
        return banded_masked_max_reference(sorted_xyz, u, radius)
    _kernel_args(sorted_xyz, u)
    B, N, C = u.shape
    from deepvcp_tpu_torch.ops.kernels._build import library

    lib = library()
    out = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.band_max_f32(
            sorted_xyz.data_ptr(), u.data_ptr(), out.data_ptr(), B, N, C,
            ctypes.c_float(float(radius)), ctypes.c_float(radius_squared(radius)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"band_max kernel launch failed: {lib.band_max_error_string(rc).decode()}")
    banded_masked_max.launches += 1
    return out


banded_masked_max.launches = 0


def banded_masked_max_grad(
    sorted_xyz: torch.Tensor, u: torch.Tensor, out: torch.Tensor, g: torch.Tensor,
    radius: float,
) -> torch.Tensor:
    """grad_u of banded_masked_max(sorted_xyz, u, radius) = out for the
    cotangent g: [B, N, C] float32. A CPU tensor runs the plain reference; a
    CUDA tensor launches the Hopper kernel (C in SUPPORTED_CHANNELS,
    contiguous inputs) or raises. `banded_masked_max_grad.launches` counts
    kernel launches."""
    _check(sorted_xyz, u, out, g)
    if sorted_xyz.device.type == "cpu" or _plain.active():
        return banded_masked_max_grad_reference(sorted_xyz, u, out, g, radius)
    _kernel_args(sorted_xyz, u, out, g)
    B, N, C = u.shape
    from deepvcp_tpu_torch.ops.kernels._build import library

    lib = library()
    grad = torch.empty_like(u)
    with torch.cuda.device(u.device):
        stream = torch.cuda.current_stream(u.device).cuda_stream
        rc = lib.band_max_grad_f32(
            sorted_xyz.data_ptr(), u.data_ptr(), out.data_ptr(), g.data_ptr(),
            grad.data_ptr(), B, N, C,
            ctypes.c_float(float(radius)), ctypes.c_float(radius_squared(radius)),
            stream,
        )
    if rc != 0:
        raise RuntimeError(
            f"band_max_grad kernel launch failed: {lib.band_max_error_string(rc).decode()}")
    banded_masked_max_grad.launches += 1
    return grad


banded_masked_max_grad.launches = 0
