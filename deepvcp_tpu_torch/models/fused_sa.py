"""Gather-free banded set abstraction (port of deepvcp_tpu/models/fused_sa.py
::BandedSetAbstraction and banded_max_pool).

The first projection of the reference SA stage, Dense(concat(x_n - x_q, f_n)),
is a difference of per-point projections, u_n - p_q + b0, so the pooled
first layer is (masked max of u over the in-radius slab) - p_q + b0: the
pair tensor is never built. The max is kernel K1 and its backward kernel K2
(ops/kernels/band_max.py), over the exact in-radius set. The rest of the MLP
runs per point.

`use_pallas_band_max=False` selects the static band instead (the JAX
package's `xla_banded_max`): each point pools over the in-radius points of a
fixed band of ceil(window / tile) tiles on each side of its own tile, torus
rolled, with the JAX formula's backward. It has no kernel: plain PyTorch on
the card too, chunked over tiles so that no [B, T, w, band, C] block is
built. It differs from the exact slab wherever the band under-covers it.

Under compute_dtype="bfloat16" the projections and the MLP tail run in bf16
(flax's Dense and BatchNorm with dtype=bf16). K1/K2 take f32 copies of the
bf16 values and cast their result back, as the JAX package's TPU dispatch
does; the static band pools on the bf16 values themselves, as its
xla_banded_max does on any backend.
"""

from __future__ import annotations

import contextlib
import contextvars
from typing import Optional

import numpy as np
import torch
from torch import nn
from torch.autograd.function import once_differentiable
from torch.nn import functional as F

from deepvcp_tpu_torch.config import SALayerConfig
from deepvcp_tpu_torch.ops.kernels.band_max import (
    NEG, banded_masked_max, banded_masked_max_grad)

BN_EPS = 1e-5        # flax.linen.BatchNorm's defaults
BN_MOMENTUM = 0.99   # flax's: running = 0.99 * running + 0.01 * batch
# the process group batch_norm reduces its training statistics over
_BN_GROUP: contextvars.ContextVar = contextvars.ContextVar("batch_norm_group", default=None)
# elements of one [B, tiles, w, w, C] block of the static band
_BAND_BLOCK = 1 << 25


class _BandedMaxPool(torch.autograd.Function):
    """K1 forward, K2 backward: the custom VJP of the JAX banded_max_pool."""

    @staticmethod
    def forward(ctx, sorted_xyz, u, radius):
        out = banded_masked_max(sorted_xyz, u, radius)
        ctx.save_for_backward(sorted_xyz, u, out)
        ctx.radius = radius
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sorted_xyz, u, out = ctx.saved_tensors
        grad_u = None
        if ctx.needs_input_grad[1]:
            grad_u = banded_masked_max_grad(sorted_xyz, u, out, g.contiguous(), ctx.radius)
        # the pooled max depends on xyz only through the piecewise-constant
        # radius mask: its gradient is zero almost everywhere (JAX returns
        # zeros; None is the same to autograd)
        return None, grad_u, None


def banded_max_pool(sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float) -> torch.Tensor:
    """Differentiable exact in-radius masked max: [B, N, 3], [B, N, C] ->
    [B, N, C]. Ties at a query's max each receive its full cotangent."""
    return _BandedMaxPool.apply(sorted_xyz.contiguous(), u.contiguous(), float(radius))


def pad_to_tiles(x: torch.Tensor, tile: int, pad_value: float) -> torch.Tensor:
    """[B, N, C] -> [B, Np, C], Np the next multiple of tile."""
    pad = (-x.shape[1]) % tile
    return x if pad == 0 else F.pad(x, (0, 0, 0, pad), value=pad_value)


def band_of(tiles: torch.Tensor, half_tiles: int) -> torch.Tensor:
    """[B, T, w, C] -> [B, T, (2 * half_tiles + 1) * w, C]: each tile's band,
    the tiles `half_tiles` before it to `half_tiles` after it in the JAX
    order (torus roll by +half_tiles first). The static band pools over it;
    _static_band walks it a few tiles at a time."""
    return torch.cat([torch.roll(tiles, s, dims=1)
                      for s in range(half_tiles, -half_tiles - 1, -1)], dim=2)


def _tile_d2(q: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """[B, t, w, 3] x [B, t, w, 3] -> [B, t, w, w] in q's dtype: the
    differences and their squares in that dtype, their sum
    ((dx*dx)+(dy*dy))+(dz*dz) in at least f32, rounded once to that dtype,
    as XLA's CPU computes jnp.sum(jnp.square(...), -1) (it sums bf16 in
    f32). Plain elementwise arithmetic: the same bits on every device."""
    d = q[:, :, :, None, :] - b[:, :, None, :, :]
    dx, dy, dz = (d * d).to(torch.promote_types(d.dtype, torch.float32)).unbind(-1)
    return ((dx + dy) + dz).to(q.dtype)


def _band_tiles(T: int, w: int, rows, reach: int, device) -> torch.Tensor:
    """The tiles (of w points, T of them) that hold rows [lo, hi) of the
    cloud, widened by `reach` tiles on each side, torus wrapped, ascending
    and each once; every tile when rows is None."""
    if rows is None:
        return torch.arange(T, device=device)
    lo, hi = rows
    t = torch.arange(lo // w - reach, (hi - 1) // w + reach + 1, device=device)
    return torch.unique(t % T)


def _static_band(sorted_xyz: torch.Tensor, C: int, radius: float, window: int, tile: int,
                 rows=None, reach: bool = False):
    """The static band of a sorted cloud, a block of tiles at a time, so
    that no [B, T, w, band, C] block is built. Returns (w, T, blocks): the
    tile width, the tile count after padding with points at 1e7 (as JAX),
    and a generator of (the block's tiles' indices, band) where band
    yields, for each band tile in the JAX order (band_of), (its tiles'
    indices, the in-radius mask [B, tiles, w, w]). r^2 is rounded to the
    cloud's dtype, as JAX's jnp.asarray(r * r, dtype).

    The blocks cover the tiles that hold `rows` [lo, hi) (every tile when
    None) and, with `reach`, the tiles whose band meets those (the receivers
    of their queries' cotangents). The tiles and the band are always the
    whole cloud's: rows need not align with tiles."""
    B, N, _ = sorted_xyz.shape
    w = min(tile, N)
    T = -(-N // w)
    half = -(-window // w)
    per_block = max(1, _BAND_BLOCK // (B * w * w * max(C, 1)))
    r2 = float(torch.tensor(float(np.float32(radius * radius))).to(sorted_xyz.dtype))
    q = pad_to_tiles(sorted_xyz, w, 1e7).reshape(B, T, w, 3)
    tiles = _band_tiles(T, w, rows, half if reach else 0, sorted_xyz.device)

    def band(t):
        for s in range(half, -half - 1, -1):
            src = (t - s) % T
            yield src, _tile_d2(q[:, t], q[:, src]) <= r2

    def blocks():
        for t0 in range(0, tiles.numel(), per_block):
            t = tiles[t0:t0 + per_block]
            yield t, band(t)

    return w, T, blocks()


@torch.no_grad()
def static_band_max(sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float,
                    window: int, tile: int, rows=None) -> torch.Tensor:
    """The JAX package's xla_banded_max: for each point of a sorted cloud,
    the per-channel max of u over the in-radius points of its band (see
    band_of); -1e30 where none. sorted_xyz [B, N, 3], u [B, N, C], both f32
    or both bf16 -> [B, N, C] in u's dtype. A max: any order is exact.

    With `rows` [lo, hi) only the tiles that hold those rows are pooled
    (a point-partitioned stage keeps its rows): the other rows are -1e30."""
    B, N, _ = sorted_xyz.shape
    C = u.shape[-1]
    w, T, blocks = _static_band(sorted_xyz, C, radius, window, tile, rows)
    ut = pad_to_tiles(u, w, 0.0).reshape(B, T, w, C)
    out = torch.full_like(ut, NEG)
    for t, band in blocks:
        acc = out[:, t]
        for src, inr in band:
            acc = torch.maximum(acc, torch.where(inr[..., None], ut[:, src, None], NEG).amax(dim=3))
        out[:, t] = acc
    return out.reshape(B, T * w, C)[:, :N]


@torch.no_grad()
def static_band_max_grad(sorted_xyz: torch.Tensor, u: torch.Tensor, out: torch.Tensor,
                         g: torch.Tensor, radius: float, window: int, tile: int,
                         rows=None) -> torch.Tensor:
    """The JAX package's static-band backward (fused_sa.py::_bmp_bwd on its
    CPU path): grad_u[n, c] = sum over the queries q of n's band of
    g[q, c] * [in radius] * [u[n, c] == out[q, c]], summed in f32 and
    returned in u's dtype (XLA sums bf16 in f32). A band that holds a tile
    more than once counts its queries that many times, as the JAX formula
    does (at N <= tile the band is 2 * half + 1 copies of the one tile).

    With `rows` [lo, hi), g is zero outside those rows (a point-partitioned
    stage's cotangent): only the tiles whose band meets theirs are summed,
    the others are 0."""
    B, N, _ = sorted_xyz.shape
    C = u.shape[-1]
    w, T, blocks = _static_band(sorted_xyz, C, radius, window, tile, rows, reach=True)
    ut, ot, gt = (pad_to_tiles(x, w, 0.0).reshape(B, T, w, C) for x in (u, out, g))
    grad = torch.zeros(ut.shape, dtype=torch.float32, device=u.device)
    for t, band in blocks:
        acc = grad[:, t]
        for src, inr in band:
            took = inr[..., None] & (ut[:, t, :, None] == ot[:, src, None])
            acc = acc + torch.where(took, gt[:, src, None].float(), 0.0).sum(dim=3)
        grad[:, t] = acc
    return grad.reshape(B, T * w, C)[:, :N].to(u.dtype)


class _StaticBandMaxPool(torch.autograd.Function):
    """The static band forward with the JAX formula's backward."""

    @staticmethod
    def forward(ctx, sorted_xyz, u, radius, window, tile, rows):
        out = static_band_max(sorted_xyz, u, radius, window, tile, rows)
        ctx.save_for_backward(sorted_xyz, u, out)
        ctx.args = (radius, window, tile, rows)
        return out

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        sorted_xyz, u, out = ctx.saved_tensors
        grad_u = None
        if ctx.needs_input_grad[1]:
            grad_u = static_band_max_grad(sorted_xyz, u, out, g, *ctx.args)
        return None, grad_u, None, None, None, None


def static_band_max_pool(sorted_xyz: torch.Tensor, u: torch.Tensor, radius: float,
                         window: int, tile: int, rows=None) -> torch.Tensor:
    """Differentiable static-band masked max: [B, N, 3], [B, N, C] -> [B, N, C].
    With `rows` [lo, hi) only those rows of the result are computed (and
    may carry a cotangent): static_band_max."""
    return _StaticBandMaxPool.apply(sorted_xyz, u, float(radius), int(window), int(tile), rows)


def linear(layer: nn.Linear, x: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """flax's Dense(dtype=...). float32: the layer. bfloat16: input, kernel and
    bias rounded to bf16, the product rounded to bf16, then the bias added in
    bf16 (two roundings, as XLA does it); the parameters stay f32."""
    if dtype == torch.float32:
        return layer(x)
    y = F.linear(x.to(dtype), layer.weight.to(dtype))
    return y if layer.bias is None else y + layer.bias.to(dtype)


def batch_norm(bn: nn.BatchNorm1d, x: torch.Tensor, training: bool,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """flax.linen.BatchNorm(dtype=...) over the last axis: statistics and the
    normalisation in f32, the result in `dtype`.

    Eval: the running statistics. Training: the batch mean and the biased
    batch variance over every other axis (flax's E[x^2] - E[x]^2, clipped
    at 0), and the running statistics move as running = 0.99 * running +
    0.01 * batch, biased variance included. F.batch_norm(training=True) would
    fold the unbiased variance into running_var, so the update is written
    out here. dtype float32 keeps the input's own (at least f32) precision.

    Inside `with batch_norm_group(group)`, whose ranks hold the other rows
    of the batch (flax's axis_name), the row counts are summed over it, then each rank's
    E[x] and E[x^2] weighted by its share of the rows, summed through
    torch.distributed.nn so that the gradient flows back to every rank's
    rows: the sums of x and x^2 over the count, so the formulas above give
    the statistics of the whole batch on every rank. Weighting the rank's
    own means (rather than summing x) leaves a group of one rank
    bit-identical to no group: in f32, E[x^2] - E[x]^2 cancels so much on
    25 m clouds that a 1-ulp change of the statistics moves the deepest
    stage's gradients by ~1e-2 of their max. nn.SyncBatchNorm would use
    torch's momentum and the unbiased variance."""
    x = x.to(torch.promote_types(x.dtype, torch.float32))
    out = x.dtype if dtype == torch.float32 else dtype
    if not training:
        shape = x.shape
        y = F.batch_norm(x.reshape(-1, shape[-1]), bn.running_mean, bn.running_var,
                         bn.weight, bn.bias, training=False, eps=BN_EPS)
        return y.reshape(shape).to(out)
    axes = tuple(range(x.dim() - 1))
    mean = x.mean(dim=axes)
    mean_sq = (x * x).mean(dim=axes)
    group = _BN_GROUP.get()
    if group is not None:
        import torch.distributed as dist
        from torch.distributed.nn.functional import all_reduce

        rows = x.numel() // x.shape[-1]
        total = x.new_full((1,), rows)
        dist.all_reduce(total, group=group)
        stats = all_reduce(torch.cat([mean, mean_sq]) * (rows / total), group=group)
        mean, mean_sq = stats.chunk(2)
    var = torch.clamp_min(mean_sq - mean * mean, 0.0)
    with torch.no_grad():
        bn.running_mean.copy_(BN_MOMENTUM * bn.running_mean + (1.0 - BN_MOMENTUM) * mean)
        bn.running_var.copy_(BN_MOMENTUM * bn.running_var + (1.0 - BN_MOMENTUM) * var)
    return ((x - mean) * (torch.rsqrt(var + BN_EPS) * bn.weight) + bn.bias).to(out)


@contextlib.contextmanager
def batch_norm_group(group):
    """Within the block, training-mode batch_norm reduces its statistics
    over the process group `group` (None: this rank's rows only). The
    train step that owns the group opens the block around its forward; the
    backward needs no block (the reductions' autograd holds the group)."""
    token = _BN_GROUP.set(group)
    try:
        yield
    finally:
        _BN_GROUP.reset(token)


class BandedSetAbstraction(nn.Module):
    """One banded SA stage on a sorted cloud: pooled first projection, then
    BN and the per-point (Dense -> BN -> ReLU) tail. Parameter names follow
    the flax module (proj_xyz, proj_feat, bias0, bn{i}, dense{i}). BN runs
    on batch statistics and updates its running ones in `train()` mode.

    `use_kernel` (use_pallas_band_max) pools over the exact slab through
    K1/K2; otherwise over the static band of the call's `window` points a
    side in tiles of `tile` (the JAX package's band_tile). `dtype` is the
    compute dtype."""

    def __init__(self, layer: SALayerConfig, in_features: Optional[int],
                 use_batchnorm: bool = True, use_kernel: bool = True, tile: int = 256,
                 dtype: torch.dtype = torch.float32):
        super().__init__()
        self.layer = layer
        self.use_batchnorm = use_batchnorm
        self.use_kernel = use_kernel
        self.tile, self.dtype = tile, dtype
        c0 = layer.mlp[0]
        self.proj_xyz = nn.Linear(3, c0, bias=False)
        self.proj_feat = nn.Linear(in_features, c0, bias=False) if in_features else None
        self.bias0 = nn.Parameter(torch.zeros(c0))
        self.n_dense = len(layer.mlp) - 1
        for i, c in enumerate(layer.mlp):
            if i > 0:
                self.add_module(f"dense{i}", nn.Linear(layer.mlp[i - 1], c))
            if use_batchnorm:
                self.add_module(f"bn{i}", nn.BatchNorm1d(c, eps=BN_EPS))

    def _norm(self, x: torch.Tensor, i: int) -> torch.Tensor:
        if not self.use_batchnorm:
            return x
        return batch_norm(getattr(self, f"bn{i}"), x, self.training, self.dtype)

    def forward(self, sorted_xyz: torch.Tensor, features: Optional[torch.Tensor],
                window: Optional[int] = None, mesh=None) -> torch.Tensor:
        """sorted_xyz [B, N, 3], features [B, N, D] or None -> [B, N, mlp[-1]]
        (sorted order). `window`: the static band's one-sided coverage in
        points, window_for(N, ...) of this call's N.

        With a `mesh` this rank computes its rows of the point group's
        split (parallel.mesh.point_shard): `features` and the result are
        its rows [B, N / P, ...], sorted_xyz the whole cloud. The
        projections and the tail run on its rows; u is all-gathered over the
        group and pooled over the whole cloud, by K1 over the exact slab
        (every row) or over the static band (the tiles that hold the rank's
        rows only), and the rank keeps its rows of the max."""
        dt = self.dtype
        # f32 keeps the input's own (at least f32) precision, as batch_norm
        xyz = sorted_xyz if dt == torch.float32 else sorted_xyz.to(dt)
        own = xyz
        if mesh is not None:
            from deepvcp_tpu_torch.parallel.mesh import (
                POINT_AXIS, axis_rows, gather_points, point_shard)

            own = point_shard(xyz, mesh)
        p = linear(self.proj_xyz, own, dt)
        u = p if features is None else p + linear(self.proj_feat, features, dt)
        if not self.use_kernel and window is None:
            raise ValueError("the static band needs a window")
        if mesh is None:
            max_u = (banded_max_pool(xyz.float(), u.float(), self.layer.radius)
                     if self.use_kernel else
                     static_band_max_pool(xyz, u, self.layer.radius, window, self.tile))
        elif self.use_kernel:
            # K1 / K2 on f32 copies of the (bf16-rounded) values, as the
            # whole path
            max_u = point_shard(banded_max_pool(
                xyz.float(), gather_points(u.float(), mesh), self.layer.radius), mesh)
        else:
            max_u = point_shard(static_band_max_pool(
                xyz, gather_points(u, mesh), self.layer.radius, window, self.tile,
                rows=axis_rows(mesh, POINT_AXIS, xyz.shape[1])), mesh)
        # relu(max) == max(relu); relu also clamps an empty row's -1e30. In
        # bf16 the f32 bias0 promotes the sum to f32, as in flax
        h = torch.relu(max_u.to(dt) - p + self.bias0)
        h = self._norm(h, 0)
        for i in range(1, self.n_dense + 1):
            h = torch.relu(self._norm(linear(getattr(self, f"dense{i}"), h, dt), i))
        return h
