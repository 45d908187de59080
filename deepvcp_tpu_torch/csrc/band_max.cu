// Banded masked max-pool over an x-sorted point cloud: kernel K1 of the port.
//
//   out[b, q, c] = max over n with |x_n - x_q|^2 <= r^2 of u[b, n, c]
//                  (-1e30 where no point lies in radius)
//
// Replaces the TPU kernel deepvcp_tpu/ops/pallas/band_max_kernel.py
// ::banded_masked_max (_band_max_kernel, with the slab search of _slab_bounds).
// It ports what that kernel computes, not Mosaic's layout: there is no
// [B, C, N] transpose, no (8, 128) padding and no scalar prefetch.
//
// Design. One block per tile of TILE consecutive sorted queries. The block
// finds its own slab [lo, hi) of candidate points by binary search over the
// sort key (x), then streams the slab through shared memory CHUNK points at a
// time. A thread owns one query and KPT channels and keeps their running
// maxima in registers; at C = 64 four threads share a query. Threads of one
// warp share their channel group, so every shared-memory read of a slab
// point's features is a broadcast.
//
// What bounds it. Each slab point's xyz and features cross HBM once per query
// tile, but are read TILE times from shared memory, and each in-radius pair
// costs KPT compare-and-max per thread. The loop is bound by shared-memory
// reads and max throughput on slab pairs, not by HBM bytes.
//
// Exactness. The slab search and the pair test are band_slab.cuh's, shared
// with K2: d2 = ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest
// intrinsics, the f32 expression the plain PyTorch version evaluates, so
// both accept the same pairs and the max, which never rounds, is
// bit-identical.

#include <cuda_runtime.h>

#include "band_slab.cuh"

namespace {

constexpr int TILE = 64;    // queries per block
constexpr int CHUNK = 128;  // slab points staged in shared memory per step
constexpr int KPT = 16;     // channels per thread; C / KPT threads share a query
constexpr float NEG = -1e30f;

template <int C>
__global__ void __launch_bounds__(TILE * (C / KPT))
band_max_kernel(const float* __restrict__ xyz, const float* __restrict__ u,
                float* __restrict__ out, int N, float radius, float r2) {
  static_assert(C % KPT == 0, "C must be a multiple of KPT");
  __shared__ float sx[CHUNK * 3];
  __shared__ __align__(16) float su[CHUNK * C];
  __shared__ int bounds[2];

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * TILE;
  const int q = tile0 + threadIdx.x % TILE;
  const int group = threadIdx.x / TILE;
  const float* bx = xyz + static_cast<size_t>(b) * N * 3;
  const float* bu = u + static_cast<size_t>(b) * N * C;

  if (threadIdx.x == 0) {
    band_slab::slab(bx, N, tile0, TILE, radius, &bounds[0], &bounds[1]);
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];

  const bool live = q < N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = bx[3 * q];
    qy = bx[3 * q + 1];
    qz = bx[3 * q + 2];
  }
  float acc[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) acc[k] = NEG;

  for (int base = lo; base < hi; base += CHUNK) {
    const int n = min(CHUNK, hi - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < n * 3; i += blockDim.x) {
      sx[i] = bx[static_cast<size_t>(base) * 3 + i];
    }
    for (int i = threadIdx.x; i < n * C; i += blockDim.x) {
      su[i] = bu[static_cast<size_t>(base) * C + i];
    }
    __syncthreads();
    for (int j = 0; j < n; ++j) {
      if (band_slab::in_radius(sx[3 * j], sx[3 * j + 1], sx[3 * j + 2], qx, qy, qz, r2)) {
        const float4* row = reinterpret_cast<const float4*>(su + j * C + group * KPT);
#pragma unroll
        for (int k = 0; k < KPT / 4; ++k) {
          const float4 v = row[k];
          acc[4 * k] = fmaxf(acc[4 * k], v.x);
          acc[4 * k + 1] = fmaxf(acc[4 * k + 1], v.y);
          acc[4 * k + 2] = fmaxf(acc[4 * k + 2], v.z);
          acc[4 * k + 3] = fmaxf(acc[4 * k + 3], v.w);
        }
      }
    }
  }
  if (live) {
    float* o = out + (static_cast<size_t>(b) * N + q) * C + group * KPT;
#pragma unroll
    for (int k = 0; k < KPT; ++k) o[k] = acc[k];
  }
}

template <int C>
int launch(const float* xyz, const float* u, float* out, int B, int N,
           float radius, float r2, cudaStream_t stream) {
  const dim3 grid((N + TILE - 1) / TILE, B);
  band_max_kernel<C><<<grid, TILE * (C / KPT), 0, stream>>>(xyz, u, out, N, radius, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. xyz [B, N, 3], u and out [B, N, C], all
// contiguous float32 on the current device; radius and r2 = f32(radius**2).
// Returns the cudaError_t of the launch (0 on success).
extern "C" int band_max_f32(const float* xyz, const float* u, float* out, int B,
                            int N, int C, float radius, float r2, void* stream) {
  if (B <= 0 || N <= 0) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 16: return launch<16>(xyz, u, out, B, N, radius, r2, s);
    case 32: return launch<32>(xyz, u, out, B, N, radius, r2, s);
    case 64: return launch<64>(xyz, u, out, B, N, radius, r2, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Message for an error code returned above.
extern "C" const char* band_max_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
