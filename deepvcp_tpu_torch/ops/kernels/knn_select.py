"""Kernel K6: the k <= 32 nearest target points of each query, in two arms.

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

`knn_select_bf16` is the same kernel on the reduced-precision selection
tile in bf16: coordinates centred on the ref mean, the product of their
bf16 roundings summed in f32, the norms of the unrounded centred
coordinates, d2 rounded to bf16 and not clamped before the selection. The
kernel orders by torch.topk's radix key of the bf16 bits (-0 below +0),
with the index packed beside it (N <= MAX_N_BF16), and returns the bf16 d2
and the indices of torch.topk's list of that tile, order included.

Each arm's tile has one plain definition here, which every selection of
the port runs where no kernel does: `knn_select_reference` (the f32 tile)
and `centred`, `tile_terms`, `tile_d2` and `tile_topk` (the
reduced-precision tile, which `knn_select_bf16_reference` runs; with no
dtype, its unrounded and unclamped f32 form, which two-level's table
selection runs in keypoint-local coordinates). The wrappers compute the
norms, the centring and the roundings with them. `applies` says when an
arm takes a call; ops/knn.py::select, the port's one k-nearest selection,
routes there.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepvcp_tpu_torch.ops.distance import square_distance
from deepvcp_tpu_torch.ops.kernels import _build, _plain

MAX_K = 32             # csrc/knn_select.cu: a query's list is one entry a lane of a warp
MAX_BATCH = 65535      # the grid's second axis
MAX_N_BF16 = 1 << 16   # the bf16 arm packs a point's index into 16 bits


def uses_kernel(t: torch.Tensor) -> bool:
    """Whether knn_select launches the kernel for tensors on t's device now
    (and not the plain version)."""
    return t.device.type != "cpu" and not _plain.active()


def applies(ref: torch.Tensor, query: torch.Tensor, k: int,
            sel: Optional[torch.dtype] = None) -> bool:
    """Whether a K6 arm takes the k nearest points of ref to each query on
    the tile of `sel` (None: knn_select, torch.bfloat16: knn_select_bf16):
    the kernel runs on their device and its wrapper accepts them, but for
    contiguity, the caller's to give."""
    return (uses_kernel(query) and ref.device == query.device
            and ref.dim() == query.dim() == 3 and ref.shape[-1] == query.shape[-1] == 3
            and 1 <= ref.shape[0] == query.shape[0] <= MAX_BATCH
            and ref.dtype == query.dtype == torch.float32
            and 1 <= k <= min(MAX_K, ref.shape[1])
            and (sel is None or (sel is torch.bfloat16 and ref.shape[1] <= MAX_N_BF16)))


def knn_select_reference(ref: torch.Tensor, query: torch.Tensor,
                         k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch K6, the f32 selection tile's one definition: torch.topk
    of square_distance's [..., M, N] tile (clamped at 0). ref [..., N, 3],
    query [..., M, 3] -> (d2, idx int64) [..., M, k], ascending d2."""
    top = torch.topk(square_distance(query, ref), k, dim=-1, largest=False)
    return top.values, top.indices


def centred(ref: torch.Tensor, query: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reduced-precision selection tile's clouds: ref and query centred
    on ref's mean."""
    center = ref.mean(dim=-2, keepdim=True)
    return ref - center, query - center


def tile_terms(x: torch.Tensor,
               sel: Optional[torch.dtype]) -> Tuple[torch.Tensor, torch.Tensor]:
    """One cloud's terms of the reduced-precision selection tile: its
    coordinates rounded to `sel` and back in f32 (None: as they are), and
    its squared norms from the unrounded coordinates."""
    return (x if sel is None else x.to(sel).float()), torch.sum(x * x, dim=-1)


def tile_d2(ref_terms, query_terms, sel: Optional[torch.dtype]) -> torch.Tensor:
    """The reduced-precision selection tile of tile_terms' (coordinates,
    norms) of ref and query: the product of the rounded coordinates summed
    in f32 (a bf16 x bf16 product is exact in f32), d2 = (s2 + r2) - 2 *
    cross cast to `sel` (None: kept in f32), not clamped. -> [..., M, N]."""
    (r, r2), (q, s2) = ref_terms, query_terms
    d2 = s2[..., :, None] + r2[..., None, :] - 2.0 * (q @ r.transpose(-1, -2))
    return d2 if sel is None else d2.to(sel)


def tile_topk(ref_terms, query_terms, k: int,
              sel: Optional[torch.dtype]) -> Tuple[torch.Tensor, torch.Tensor]:
    """torch.topk of tile_d2: (d2 in `sel`, idx int64) [..., M, k],
    ascending d2."""
    top = torch.topk(tile_d2(ref_terms, query_terms, sel), k, dim=-1, largest=False)
    return top.values, top.indices


def knn_select_bf16_reference(ref: torch.Tensor, query: torch.Tensor,
                              k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Plain PyTorch bf16 K6: the bf16 selection tile of ref and query
    centred on ref's mean, and torch.topk of it. ref [B, N, 3], query
    [B, M, 3] -> (d2 bfloat16, idx int64) [B, M, k]."""
    ref, query = centred(ref, query)
    return tile_topk(tile_terms(ref, torch.bfloat16), tile_terms(query, torch.bfloat16), k,
                     torch.bfloat16)


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


def _launch(wrapper, entry: str, ref: torch.Tensor, query: torch.Tensor, s2: torch.Tensor,
            r2: torch.Tensor, k: int, dtype: torch.dtype) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch of the library's `entry` on CUDA tensors, counted on
    `wrapper.launches`, then torch.topk's last step: sort the set by d2 (the
    kernel laid it out as torch.topk lays out its set before this sort)."""
    B, M, _ = query.shape
    N = ref.shape[1]
    if B > MAX_BATCH:
        raise ValueError(f"B={B} exceeds the kernel's {MAX_BATCH}")
    if not query.is_cuda:
        raise ValueError(f"no kernel for device {query.device}")
    d2 = torch.empty((B, M, k), dtype=dtype, device=query.device)
    idx = torch.empty((B, M, k), dtype=torch.int64, device=query.device)
    if M == 0:
        return d2, idx
    _build.launch(getattr(_build.library(), entry), query, query.data_ptr(), s2.data_ptr(),
                  ref.data_ptr(), r2.data_ptr(), d2.data_ptr(), idx.data_ptr(), B, M, N, k)
    wrapper.launches += 1
    d2, order = torch.sort(d2, dim=-1)
    return d2, torch.gather(idx, -1, order)


def knn_select(ref: torch.Tensor, query: torch.Tensor,
               k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k <= 32 nearest points of ref [B, N, 3] to each query [B, M, 3],
    both contiguous float32: (d2 [B, M, k] float32, idx [B, M, k] int64),
    torch.topk's list. A CPU tensor runs the plain reference; a CUDA
    tensor launches the Hopper kernel or raises. Records no autograd graph.
    `knn_select.launches` counts kernel launches."""
    _check(ref, query, k)
    with torch.no_grad():
        if not uses_kernel(query):
            return knn_select_reference(ref, query, k)
        # square_distance's norms, op for op
        (ref, r2), (query, s2) = tile_terms(ref, None), tile_terms(query, None)
    return _launch(knn_select, "knn_select_f32", ref, query, s2, r2, k, torch.float32)


knn_select.launches = 0


def knn_select_bf16(ref: torch.Tensor, query: torch.Tensor,
                    k: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k <= 32 nearest points of ref [B, N, 3] (N <= MAX_N_BF16) to each
    query [B, M, 3], both contiguous float32, on the bf16 selection tile:
    (d2 [B, M, k] bfloat16, idx [B, M, k] int64), torch.topk's list of that
    tile (d2 not clamped). A CPU tensor runs the plain reference; a
    CUDA tensor launches the Hopper kernel or raises. Records no autograd
    graph. `knn_select_bf16.launches` counts kernel launches."""
    _check(ref, query, k)
    if ref.shape[1] > MAX_N_BF16:
        raise ValueError(f"N={ref.shape[1]} exceeds the bf16 arm's {MAX_N_BF16}")
    with torch.no_grad():
        if not uses_kernel(query):
            return knn_select_bf16_reference(ref, query, k)
        ref, query = centred(ref, query)
        (ref, r2), (query, s2) = tile_terms(ref, torch.bfloat16), tile_terms(query, torch.bfloat16)
    return _launch(knn_select_bf16, "knn_select_bf16", ref, query, s2, r2, k, torch.bfloat16)


knn_select_bf16.launches = 0
