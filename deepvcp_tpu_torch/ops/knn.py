"""Brute-force K-nearest neighbours (port of deepvcp_tpu/ops/knn.py).

On the TPU, `approx_knn` selects with `jax.lax.approx_min_k`; here both
functions select EXACTLY, which is also what the JAX package does on the
CPU: `knn` on a chunked distance tile with `torch.topk(largest=False)`,
`approx_knn` on the card in f32 or on the bf16 selection tile with k <= 32
through kernel K6 (ops/kernels/knn_select.py: no tile, torch.topk's
result), otherwise as `knn`. `approx_knn` keeps its reduced-precision
selection semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepvcp_tpu_torch.ops.distance import map_query_chunks, square_distance
from deepvcp_tpu_torch.ops.kernels import knn_select as k6
from deepvcp_tpu_torch.utils.profiling import annotate


def knn(ref: torch.Tensor, query: torch.Tensor, k: int,
        chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ref [B, N, 3], query [B, M, 3] -> (dist [B, M, k] ascending euclidean
    distances, idx [B, M, k] int64 indices into N)."""

    def run(q):
        d2, idx = torch.topk(square_distance(q, ref), k, dim=-1, largest=False)
        return torch.sqrt(torch.clamp_min(d2, 0.0)), idx

    if chunk is None:
        return run(query)
    return map_query_chunks(run, query, chunk)


def approx_knn(ref: torch.Tensor, query: torch.Tensor, k: int,
               chunk: Optional[int] = None,
               select_dtype: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """knn with the JAX `approx_knn` contract: exact selection here, and
    with `select_dtype` (e.g. "bfloat16") the reduced-precision selection
    tile: coordinates centred on the ref mean, inputs rounded to that dtype,
    the product accumulated in f32 (a bf16 x bf16 product is exact in f32,
    so upcasting before the matmul is "bf16 in, f32 accumulate"), and d^2
    cast down for the selection. Returned distances are then in that
    reduced precision. On the card, with k <= 32 and [B, N, 3] / [B, M, 3]
    f32 clouds of one B, the selection is kernel K6's (torch.topk's list of
    the tile), one launch for all queries (it keeps no tile, so `chunk`
    does not apply): knn_select in f32, and knn_select_bf16 on the bf16
    tile (N <= 65 536) inside one `deepvcp.select_tile` profiler range.
    Otherwise each chunk's tile and top-k run inside a
    `deepvcp.select_tile` range."""
    sel = getattr(torch, select_dtype) if select_dtype else None
    if (k <= k6.MAX_K and k6.uses_kernel(query)
            and ref.dtype == query.dtype == torch.float32
            and ref.dim() == query.dim() == 3 and ref.shape[0] == query.shape[0]):
        if sel is None:
            d2, idx = k6.knn_select(ref.contiguous(), query.contiguous(), k)
            return torch.sqrt(d2), idx
        if sel is torch.bfloat16 and ref.shape[1] <= k6.MAX_N_BF16:
            with annotate("deepvcp.select_tile"):
                d2, idx = k6.knn_select_bf16(ref.contiguous(), query.contiguous(), k)
            return torch.sqrt(torch.clamp_min(d2, 0.0).float()), idx
    if sel is not None:
        ref, query = k6.centred(ref, query)
        ref_terms = k6.tile_terms(ref, sel)

    def run(q):
        with annotate("deepvcp.select_tile"):
            if sel is not None:
                d2, idx = k6.tile_topk(ref_terms, k6.tile_terms(q, sel), k, sel)
            else:
                d2, idx = torch.topk(square_distance(q, ref), k, dim=-1, largest=False)
        return torch.sqrt(torch.clamp_min(d2, 0.0).float()), idx

    if chunk is None:
        return run(query)
    return map_query_chunks(run, query, chunk)


def nearest_neighbor_dist(ref: torch.Tensor, query: torch.Tensor,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Squared distance from each query [B, M, 3] to its nearest point of
    ref [B, N, 3] -> [B, M]."""

    def run(q):
        return (torch.amin(square_distance(q, ref), dim=-1),)

    if chunk is None:
        return run(query)[0]
    return map_query_chunks(run, query, chunk)[0]
