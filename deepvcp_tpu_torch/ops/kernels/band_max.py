"""Kernel K1: banded masked max-pool over an x-sorted cloud.

    pooled[b, q, c] = max over n with |x_n - x_q|^2 <= r^2 of u[b, n, c]

The inner loop of every banded set-abstraction stage
(models/fused_sa.py). On a CUDA tensor `banded_masked_max` launches the
hand-written Hopper kernel in `csrc/band_max.cu`, which replaces the TPU
kernel `deepvcp_tpu/ops/pallas/band_max_kernel.py::banded_masked_max`; on a
CPU tensor it runs `banded_masked_max_reference`, the plain PyTorch version
of the same function. Both give bit-identical results (see the source note in
band_max.cu for why).

Semantics: the EXACT in-radius set, with no cap on the number of neighbours,
which is what the TPU kernel computed and what the checkpoints were trained
under. The JAX model on CPU computes something else: its SA stages run
`xla_banded_max` (deepvcp_tpu/models/fused_sa.py), a static torus-rolled band
of `window_for(N, r, extent, safety)` sorted positions per side. The two
agree only when that band covers the whole slab, i.e. when
`window_for(...) >= N`, as at `DeepVCPConfig.tiny()`. So the port is held
against the JAX model at such tiny configs, and against the Pallas kernel in
interpret mode for its own semantics.

Not differentiable yet: the backward is kernel K2 (ROADMAP M7).
"""

from __future__ import annotations

import contextlib
import ctypes

import numpy as np
import torch

NEG = -1e30
SUPPORTED_CHANNELS = (16, 32, 64)  # the SA stages' first widths
_REFERENCE_CHUNK = 64  # queries per [B, chunk, N, C] block of the plain version


def radius_squared(radius: float) -> float:
    """r^2 rounded once to f32, the threshold both versions compare with."""
    return float(np.float32(float(radius) ** 2))


def banded_masked_max_reference(
    sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float
) -> torch.Tensor:
    """Plain PyTorch exact in-radius masked max over the whole cloud,
    chunked over queries so that a [B, 64, N, C] block bounds memory.

    sorted_xyz [B, N, 3], u [B, N, C] float32 -> [B, N, C] float32; rows with
    no point in radius get -1e30. Does not use the sort: it is the
    definition the kernel's slab search must reproduce."""
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


def _check(sorted_xyz: torch.Tensor, u: torch.Tensor) -> None:
    if sorted_xyz.dim() != 3 or sorted_xyz.shape[-1] != 3:
        raise ValueError(f"sorted_xyz must be [B, N, 3], got {tuple(sorted_xyz.shape)}")
    if u.dim() != 3 or u.shape[:2] != sorted_xyz.shape[:2]:
        raise ValueError(
            f"u must be [B, N, C] matching sorted_xyz {tuple(sorted_xyz.shape)}, "
            f"got {tuple(u.shape)}")
    if sorted_xyz.dtype != torch.float32 or u.dtype != torch.float32:
        raise TypeError(f"float32 only, got {sorted_xyz.dtype} and {u.dtype}")
    if sorted_xyz.device != u.device:
        raise ValueError(f"tensors on {sorted_xyz.device} and {u.device}")
    if sorted_xyz.requires_grad or u.requires_grad:
        raise NotImplementedError(
            "banded_masked_max is not differentiable yet: its backward is "
            "kernel K2 (banded_masked_max_grad), ROADMAP M7. Run inference "
            "under torch.no_grad().")


def banded_masked_max(
    sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float
) -> torch.Tensor:
    """pooled[b, q, c] = max over n with |x_n - x_q| <= radius of u[b, n, c].

    sorted_xyz [B, N, 3] sorted ascending by x, u [B, N, C], both float32
    -> [B, N, C] float32. A CPU tensor runs the plain reference; a CUDA
    tensor launches the Hopper kernel (C in SUPPORTED_CHANNELS, contiguous
    inputs) or raises. `banded_masked_max.launches` counts kernel launches."""
    _check(sorted_xyz, u)
    if sorted_xyz.device.type == "cpu" or banded_masked_max.reference_on_cuda:
        return banded_masked_max_reference(sorted_xyz, u, radius)
    if sorted_xyz.device.type != "cuda":
        raise ValueError(f"no kernel for device {sorted_xyz.device}")
    B, N, C = u.shape
    if C not in SUPPORTED_CHANNELS:
        raise ValueError(f"C={C} not in the kernel's {SUPPORTED_CHANNELS}")
    if not (sorted_xyz.is_contiguous() and u.is_contiguous()):
        raise ValueError("banded_masked_max needs contiguous inputs")
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
# Test-only switch: route CUDA tensors through the plain reference, to hold
# the kernel path against the plain path end to end. Use `reference_path()`.
banded_masked_max.reference_on_cuda = False


@contextlib.contextmanager
def reference_path():
    """Within this block, banded_masked_max runs the plain PyTorch version on
    CUDA tensors too (for comparing the two paths on the card)."""
    prev = banded_masked_max.reference_on_cuda
    banded_masked_max.reference_on_cuda = True
    try:
        yield
    finally:
        banded_masked_max.reference_on_cuda = prev
