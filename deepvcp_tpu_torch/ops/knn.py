"""Brute-force K-nearest neighbours (port of deepvcp_tpu/ops/knn.py).

On the TPU, `approx_knn` selects with `jax.lax.approx_min_k`; here every
selection is EXACT, which is also what the JAX package does on the CPU.
`select` is the port's one k-nearest selection: kernel K6
(ops/kernels/knn_select.py: no tile, torch.topk's result) where one of its
arms applies, otherwise the arm's plain tile, chunked, and torch.topk.
`knn` and `approx_knn` are its public faces; `approx_knn` keeps its
reduced-precision selection semantics.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from deepvcp_tpu_torch.ops.distance import map_query_chunks, square_distance
from deepvcp_tpu_torch.ops.kernels import knn_select as k6
from deepvcp_tpu_torch.utils.profiling import annotate


def select(ref: torch.Tensor, query: torch.Tensor, k: int, select_dtype: Optional[str] = None,
           chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """The k nearest points of ref [B, N, 3] to each query [B, M, 3]: (d2
    [B, M, k], idx [B, M, k] int64), torch.topk's list of the selection
    tile. select_dtype None: square_distance's f32 tile; e.g. "bfloat16":
    the reduced-precision tile of the clouds centred on ref's mean, d2 in
    that dtype and not clamped. Where k6.applies, one launch of K6's arm
    for all queries (it keeps no tile, so `chunk` does not apply);
    otherwise the plain tile and torch.topk, `chunk` queries at a time.
    The bf16 arm and each chunk of the plain tile run inside a
    `deepvcp.select_tile` profiler range, K6's f32 arm in none."""
    sel = getattr(torch, select_dtype) if select_dtype else None
    if k6.applies(ref, query, k, sel):
        if sel is None:
            return k6.knn_select(ref.contiguous(), query.contiguous(), k)
        with annotate("deepvcp.select_tile"):
            return k6.knn_select_bf16(ref.contiguous(), query.contiguous(), k)
    if sel is not None:
        ref, query = k6.centred(ref, query)
        ref_terms = k6.tile_terms(ref, sel)

    def run(q):
        with annotate("deepvcp.select_tile"):
            if sel is None:
                return k6.knn_select_reference(ref, q, k)
            return k6.tile_topk(ref_terms, k6.tile_terms(q, sel), k, sel)

    if chunk is None:
        return run(query)
    return map_query_chunks(run, query, chunk)


def approx_knn(ref: torch.Tensor, query: torch.Tensor, k: int,
               chunk: Optional[int] = None,
               select_dtype: Optional[str] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """knn with the JAX `approx_knn` contract: exact selection here
    (`select`), and with `select_dtype` (e.g. "bfloat16") on the
    reduced-precision selection tile, whose returned distances are then in
    that reduced precision. -> (dist [B, M, k] ascending euclidean
    distances, idx [B, M, k] int64 indices into N)."""
    d2, idx = select(ref, query, k, select_dtype, chunk)
    if not select_dtype and k6.applies(ref, query, k):
        return torch.sqrt(d2), idx   # K6's f32 list: square_distance's d2, >= 0
    return torch.sqrt(torch.clamp_min(d2, 0.0).float()), idx


def knn(ref: torch.Tensor, query: torch.Tensor, k: int,
        chunk: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """ref [B, N, 3], query [B, M, 3] -> (dist [B, M, k] ascending euclidean
    distances, idx [B, M, k] int64 indices into N): approx_knn's f32
    selection, the same exact one."""
    return approx_knn(ref, query, k, chunk=chunk)


def nearest_neighbor_dist(ref: torch.Tensor, query: torch.Tensor,
                          chunk: Optional[int] = None) -> torch.Tensor:
    """Squared distance from each query [B, M, 3] to its nearest point of
    ref [B, N, 3] -> [B, M]."""

    def run(q):
        return (torch.amin(square_distance(q, ref), dim=-1),)

    if chunk is None:
        return run(query)[0]
    return map_query_chunks(run, query, chunk)[0]
