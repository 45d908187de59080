// The slab search shared by kernels K1 (band_max.cu) and K2
// (band_max_grad.cu), and the exact in-radius test both apply inside it.
//
// A block owns the tile [tile0, tile_end) of an x-sorted cloud. Every point
// within `radius` of a tile point has its x within radius of the tile's x
// range, so the block's candidates form one contiguous slab [lo, hi) of the
// sorted order, found by two binary searches over the sort key. The relation
// is symmetric, so the same slab serves K1 (the tile holds queries, the slab
// the points they pool) and K2 (the tile holds gradient receivers, the slab
// the queries that can see them).
//
// The bounds are widened by 2^-16 of the coordinate magnitude so that f32
// rounding in the bound can never drop a point the mask accepts: the mask
// alone decides membership, and the widening changes no result.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace band_slab {

// First i in [0, n) with xyz[3 i] >= v, or n.
__device__ inline int lower_bound_key(const float* xyz, int n, float v) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (xyz[3 * mid] < v) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// [lo, hi) of the sorted cloud bx [N, 3] that can lie within radius of a
// point of the tile [tile0, min(tile0 + tile, N)).
__device__ inline void slab(const float* bx, int N, int tile0, int tile,
                            float radius, int* lo, int* hi) {
  const int last = min(tile0 + tile, N) - 1;
  const float x_first = bx[3 * tile0];
  const float x_last = bx[3 * last];
  const float reach_lo = radius + (fabsf(x_first) + radius) * 0x1p-16f;
  const float reach_hi = radius + (fabsf(x_last) + radius) * 0x1p-16f;
  *lo = lower_bound_key(bx, N, x_first - reach_lo);
  // first key > x_last + reach: lower bound of the next float up
  *hi = lower_bound_key(bx, N, nextafterf(x_last + reach_hi, CUDART_INF_F));
}

// |a - b|^2 <= r2 as ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest f32
// intrinsics, which nvcc cannot contract into FMAs: the plain PyTorch
// versions evaluate the same expression, so every version accepts the same
// pairs. Round-to-nearest subtraction is odd (fl(a - b) = -fl(b - a)), so
// d2 does not depend on which point is `a`: K1 and K2 accept the same pairs.
__device__ __forceinline__ bool in_radius(float ax, float ay, float az, float bx,
                                          float by, float bz, float r2) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  const float d2 = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                             __fmul_rn(dz, dz));
  return d2 <= r2;
}

}  // namespace band_slab
