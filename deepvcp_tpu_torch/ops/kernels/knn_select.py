"""Kernel K6: the k <= 32 nearest target points of each query.

    d2[b, m, n] = clamp_min((|q[b, m]|^2 + |p[b, n]|^2) - 2 q[b, m].p[b, n], 0)
    out[b, m]   = torch.topk(d2[b, m], k, largest=False)

d2 is ops/distance.py::square_distance's, and the list is torch.topk's: on
a CUDA tensor `knn_select` launches the hand-written Hopper kernel in
`csrc/knn_select.cu`, which keeps the distance tile on chip and writes only
the [B, M, k] set, and returns the same values and indices, in the same
order, as torch.topk of the tile on the card; on a CPU tensor, or within
`ops.kernels.reference_path()`, it runs the plain PyTorch version
`knn_select_reference`, which is that torch.topk (the port's f32 selection
before K6). On the card torch.topk keeps the lower index of a tie at the
k-th distance (its radix select takes the first seen) and orders its list
by sorting the set laid out in ascending index with those ties last
(`torch.sort`, not stable: equal distances keep no set order); the kernel
selects the k smallest (d2, index) and lays them out so, and the wrapper
sorts them with the same torch.sort. The kernel forms the product in the
order of cuBLAS's f32 GEMM and the wrapper computes the squared norms with
square_distance's ops, so both select on the same d2 bits. The list must
match bit for bit, order included: the registrar's later stages sum over
each list in its order, and in kitti25-rot's three guarded refinements an
ulp there grew to 0.04 deg of pose (PERF.md, K6). It replaces no TPU
kernel: the JAX package selects with XLA's `jax.lax.approx_min_k`.
ops/knn.py::approx_knn routes its f32 selection on the card here for
k <= MAX_K.
"""

from __future__ import annotations

from typing import Tuple

import torch

from deepvcp_tpu_torch.ops.distance import square_distance
from deepvcp_tpu_torch.ops.kernels import _build, _plain

MAX_K = 32             # csrc/knn_select.cu: a query's list is one entry a lane of a warp
MAX_BATCH = 65535      # the grid's second axis


def uses_kernel(t: torch.Tensor) -> bool:
    """Whether knn_select launches the kernel for tensors on t's device now
    (and not the plain version)."""
    return t.device.type != "cpu" and not _plain.active()


@torch.no_grad()
def knn_select_reference(ref: torch.Tensor, query: torch.Tensor,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6: torch.topk of square_distance's [B, M, N] tile.
    ref [B, N, 3], query [B, M, 3] -> (d2, idx) [B, M, k], ascending d2."""
    top = torch.topk(square_distance(query, ref), k, dim=-1, largest=False)
    return top.values, top.indices


def _check(ref: torch.Tensor, query: torch.Tensor, k: int) -> None:
    if ref.dim() != 3 or query.dim() != 3 or ref.shape[-1] != 3 or query.shape[-1] != 3:
        raise ValueError(f"ref and query must be [B, N, 3] and [B, M, 3], got "
                         f"{tuple(ref.shape)} and {tuple(query.shape)}")
    if ref.shape[0] != query.shape[0] or ref.shape[0] < 1 or ref.shape[1] < 1:
        raise ValueError(f"ref {tuple(ref.shape)} and query {tuple(query.shape)} disagree on B, "
                         f"or B or N is 0")
    if ref.dtype != torch.float32 or query.dtype != torch.float32:
        raise TypeError(f"float32 only, got {ref.dtype} and {query.dtype}")
    if not 1 <= k <= min(MAX_K, ref.shape[1]):
        raise ValueError(f"k must lie in [1, min({MAX_K}, N = {ref.shape[1]})], got {k}")
    if ref.device != query.device:
        raise ValueError(f"tensors on {ref.device} and {query.device}")
    if not (ref.is_contiguous() and query.is_contiguous()):
        raise ValueError("knn_select needs contiguous inputs")


def knn_select(ref: torch.Tensor, query: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k <= 32 nearest points of ref [B, N, 3] to each query [B, M, 3],
    both contiguous float32: (d2 [B, M, k] float32, idx [B, M, k] int64),
    torch.topk's list. A CPU tensor runs the plain reference; a CUDA
    tensor launches the Hopper kernel or raises. Records no autograd graph.
    `knn_select.launches` counts kernel launches."""
    _check(ref, query, k)
    if not uses_kernel(query):
        return knn_select_reference(ref, query, k)
    if not query.is_cuda:
        raise ValueError(f"no kernel for device {query.device}")
    B, M, _ = query.shape
    N = ref.shape[1]
    if B > MAX_BATCH:
        raise ValueError(f"B={B} exceeds the kernel's {MAX_BATCH}")
    d2 = query.new_empty((B, M, k))
    idx = torch.empty((B, M, k), dtype=torch.int64, device=query.device)
    if M == 0:
        return d2, idx
    with torch.no_grad():
        # square_distance's norms, op for op
        s2 = torch.sum(query * query, dim=-1)
        r2 = torch.sum(ref * ref, dim=-1)
    _build.launch(_build.library().knn_select_f32, query, query.data_ptr(), s2.data_ptr(),
                  ref.data_ptr(), r2.data_ptr(), d2.data_ptr(), idx.data_ptr(), B, M, N, k)
    knn_select.launches += 1
    # torch.topk's last step: sort the set by d2 (the kernel laid it out as
    # torch.topk lays out its set before this sort)
    d2, order = torch.sort(d2, dim=-1)
    return d2, torch.gather(idx, -1, order)


knn_select.launches = 0
