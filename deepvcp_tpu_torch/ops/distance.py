"""Pairwise squared-distance ops (port of deepvcp_tpu/ops/distance.py).

The same |a|^2 + |b|^2 - 2 a.b expansion as the JAX package, so that the
product rides one matmul, and a chunked loop that bounds memory to one
[chunk, N] tile at a time.
"""

from __future__ import annotations

from typing import Callable

import torch


def square_distance(src: torch.Tensor, dst: torch.Tensor) -> torch.Tensor:
    """[..., N, C] x [..., M, C] -> [..., N, M] squared euclidean distances,
    clamped at 0 against cancellation. float32 products stay float32 on the
    card because the package turns TF32 off."""
    s2 = torch.sum(src * src, dim=-1)
    d2 = torch.sum(dst * dst, dim=-1)
    cross = src @ dst.transpose(-1, -2)
    return torch.clamp_min(s2[..., :, None] + d2[..., None, :] - 2.0 * cross, 0.0)


def map_query_chunks(
    fn: Callable, queries: torch.Tensor, chunk: int, dim: int = -2
):
    """Apply `fn` (returning a tuple of tensors) over blocks of `chunk`
    queries along `dim` and concatenate each result along the same dim.
    Unlike the JAX version no padding is needed: eager blocks may be ragged.
    As in JAX, `dim` counts from the front of `queries` for the results too,
    so a result with fewer trailing axes (a per-query count) is joined on
    the same query axis."""
    dim = dim % queries.dim()
    if queries.shape[dim] <= chunk:
        return fn(queries)
    outs = [fn(q) for q in torch.split(queries, chunk, dim=dim)]
    return tuple(torch.cat(parts, dim=dim) for parts in zip(*outs))
