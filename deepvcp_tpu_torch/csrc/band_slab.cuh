// The slab search shared by kernels K1 (band_max.cu) and K2
// (band_max_grad.cu), the exact in-radius test both apply inside it, and
// the cp.async copies with which both stream the slab through shared
// memory.
//
// A block owns the tile [tile0, tile_end) of an x-sorted cloud. Every point
// within `radius` of a tile point has its x within radius of the tile's x
// range, so the block's candidates form one contiguous slab [lo, hi) of the
// sorted order, found by two searches over the sort key, each by one warp
// (lower_bound_key_warp). The relation is symmetric, so the same slab
// serves K1 (the tile holds queries, the slab the points they pool) and K2
// (the tile holds gradient receivers, the slab the queries that can see
// them).
//
// The bounds are widened by 2^-16 of the coordinate magnitude so that f32
// rounding in the bound can never drop a point the mask accepts: the mask
// alone decides membership, and the widening changes no result.

#pragma once

#include <cuda_runtime.h>
#include <math_constants.h>

namespace band_slab {

// The keys that bound the slab of the tile [tile0, last]: lo is the first
// point with x >= slab_lo_key, hi the first with x >= slab_hi_key (the lower
// bound of the next float above the widened reach).
__device__ __forceinline__ float slab_lo_key(const float* bx, int tile0, float radius) {
  const float x_first = bx[3 * tile0];
  return x_first - (radius + (fabsf(x_first) + radius) * 0x1p-16f);
}

__device__ __forceinline__ float slab_hi_key(const float* bx, int last, float radius) {
  const float x_last = bx[3 * last];
  return nextafterf(x_last + (radius + (fabsf(x_last) + radius) * 0x1p-16f), CUDART_INF_F);
}

// First i in [0, n) with xyz[3 i] >= v, or n, found by one warp: each
// round 32 lanes probe the remaining range at 32 cut points and a ballot
// keeps the part that holds the bound, so N = 10 000 takes three rounds of
// one load each, not ~14 dependent loads. Every lane returns the same
// index.
__device__ inline int lower_bound_key_warp(const float* xyz, int n, float v) {
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = n;  // the bound lies in [lo, hi]; hi == n or xyz[3 hi] >= v
  while (hi - lo > 32) {
    const int len = hi - lo;
    const int probe = lo + static_cast<int>((static_cast<long long>(lane + 1) * len) / 33);
    const unsigned ge = __ballot_sync(0xffffffffu, xyz[3 * probe] >= v);
    if (ge == 0u) {
      lo = lo + static_cast<int>((32LL * len) / 33) + 1;
    } else {
      const int k = __ffs(ge) - 1;
      const int new_hi = lo + static_cast<int>((static_cast<long long>(k + 1) * len) / 33);
      lo = k == 0 ? lo : lo + static_cast<int>((static_cast<long long>(k) * len) / 33) + 1;
      hi = new_hi;
    }
  }
  const unsigned ge = __ballot_sync(0xffffffffu, lo + lane < hi && xyz[3 * (lo + lane)] >= v);
  return ge == 0u ? hi : lo + __ffs(ge) - 1;
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

// Asynchronous copies of 4 or 16 bytes from global to shared memory, and
// the group fences of a two-stage ring: commit what was issued, then wait
// until at most one group (the stage being filled) is still in flight.
__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Stage the xyz of points [base, base + n) of the sorted cloud bx [N, 3]
// into dst[0, n) as float4s (w unused); THREADS threads share the copies.
template <int THREADS>
__device__ __forceinline__ void stage_xyz(float4* dst, const float* bx, int base, int n) {
  float* sx = reinterpret_cast<float*>(dst);
  for (int i = threadIdx.x; i < n * 3; i += THREADS) {
    const int r = i / 3;
    cp_async4(sx + 4 * r + (i - 3 * r), bx + static_cast<size_t>(base) * 3 + i);
  }
}

// Stage channels [c0, c0 + cw) of rows [base, base + n) of the row-major
// [N, C] matrix src into dst, KC floats a row (cw <= KC; a row's channels
// past cw are left as they are). vec: C % 4 == 0 and src 16-byte aligned,
// so rows go as 16-byte pieces; else as 4-byte elements.
template <int KC, int THREADS>
__device__ __forceinline__ void stage_window(float4* dst, const float* src, int base, int n,
                                             int C, int c0, int cw, bool vec) {
  if (vec && cw == KC) {  // whole 16-byte rows of the window
    for (int i = threadIdx.x; i < n * (KC / 4); i += THREADS) {
      const int r = i / (KC / 4), k = i % (KC / 4);
      cp_async16(&dst[i], src + static_cast<size_t>(base + r) * C + c0 + 4 * k);
    }
  } else if (vec) {  // cw % 4 == 0 and 16-byte aligned rows
    const int per_row = cw / 4;
    for (int i = threadIdx.x; i < n * per_row; i += THREADS) {
      const int r = i / per_row, k = i - r * per_row;
      cp_async16(&dst[r * (KC / 4) + k], src + static_cast<size_t>(base + r) * C + c0 + 4 * k);
    }
  } else {
    float* sd = reinterpret_cast<float*>(dst);
    for (int i = threadIdx.x; i < n * cw; i += THREADS) {
      const int r = i / cw, k = i - r * cw;
      cp_async4(sd + r * KC + k, src + static_cast<size_t>(base + r) * C + c0 + k);
    }
  }
}

}  // namespace band_slab
