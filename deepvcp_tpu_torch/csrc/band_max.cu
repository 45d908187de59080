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
// Design. One block per tile of 32 consecutive sorted queries and window of
// KC channels (KC = 16, 32 or 64, a template parameter; a wider C takes
// several windows, blockIdx.y). A lane owns one query and keeps the
// window's KC running maxima in registers, so each (query, point) pair is
// tested once, not once per channel group.
//   - Slab search: warp 0 finds lo and warp 1 hi by the warp-cooperative
//     search of band_slab.cuh (three rounds of 32 probes at N = 10 000, in
//     place of one thread's two serial binary searches).
//   - Staging: the slab streams through a two-stage cp.async ring of CHUNK
//     = 128 points (xyz as float4, the window's channels), so the next
//     chunk loads while the current one is tested.
//   - Split: SW warps (4 at KC = 16, 8 above) take interleaved points of
//     each chunk, so a long slab is shared by SW warps of the tile's 32
//     queries; a point's row is read (a broadcast) only where some lane's
//     query holds it, a warp-uniform branch.
//   - Merge: each warp's maxima go to shared memory and the block takes
//     their max, written as whole rows. fmaxf is exact and order-free, so
//     the split changes no bit.
// Any C >= 1: a window's channels past C are staged from nowhere and never
// written; C % 4 == 0 stages 16-byte rows, other C 4-byte elements.
// Larger tiles (64-256 queries a block, each staged row read by more
// queries) and other splits were slower on both shape families (PERF.md §6).
//
// What bounds it. At the serving shapes (slabs of 150-800 points, 1-2% of
// the pairs in radius), latency: the search, the loads and few warps a
// tile. On the object-scale clouds of the cascade (slabs of thousands of
// points, up to 64% of the pairs in radius), the KC max operations a lane
// does per in-radius point and the divergence of the lanes that do not.
//
#include <cuda_runtime.h>

#include "band_slab.cuh"

namespace {

constexpr int TILE = 32;     // queries per block, a lane each
constexpr int CHUNK = 128;   // slab points per stage of the ring
constexpr float NEG = -1e30f;

// A block: SW warps over one tile of 32 queries, each taking every SW-th
// point of a chunk. Dynamic shared memory holds the ring, then the merge.
template <int KC, int SW>
struct Shape {
  static constexpr int THREADS = 32 * SW;
  struct Ring {
    float4 x[2][CHUNK];           // xyz of a chunk's points (w unused)
    float4 u[2][CHUNK * KC / 4];  // the window's channels, row-major
  };
  static constexpr int MERGE = SW * TILE * (KC + 1) * 4;
  static constexpr int SMEM = sizeof(Ring) > MERGE ? sizeof(Ring) : MERGE;
};

// Stage points [base, base + n) of the slab into ring stage st.
template <int KC, int SW>
__device__ __forceinline__ void stage(typename Shape<KC, SW>::Ring& ring, int st, const float* bx,
                                      const float* bu, int base, int n, int C, int c0, int cw,
                                      bool vec) {
  constexpr int THREADS = Shape<KC, SW>::THREADS;
  band_slab::stage_xyz<THREADS>(ring.x[st], bx, base, n);
  band_slab::stage_window<KC, THREADS>(ring.u[st], bu, base, n, C, c0, cw, vec);
}

template <int KC, int SW>
__global__ void __launch_bounds__(Shape<KC, SW>::THREADS)
band_max_kernel(const float* __restrict__ xyz, const float* __restrict__ u,
                float* __restrict__ out, int N, int C, float radius, float r2) {
  using S = Shape<KC, SW>;
  extern __shared__ float4 smem[];
  typename S::Ring& ring = *reinterpret_cast<typename S::Ring*>(smem);
  __shared__ int bounds[2];

  const int b = blockIdx.z;
  const int tile0 = blockIdx.x * TILE;
  const int c0 = blockIdx.y * KC;
  const int cw = min(KC, C - c0);
  const bool vec = C % 4 == 0 && reinterpret_cast<size_t>(u) % 16 == 0;
  const int lane = threadIdx.x & 31;
  const int sw = threadIdx.x >> 5;  // which share of each chunk
  const int q = tile0 + lane;
  const float* bx = xyz + static_cast<size_t>(b) * N * 3;
  const float* bu = u + static_cast<size_t>(b) * N * C;

  if (sw == 0) {
    const int lo = band_slab::lower_bound_key_warp(bx, N, band_slab::slab_lo_key(bx, tile0, radius));
    if (lane == 0) bounds[0] = lo;
  } else if (sw == 1) {
    const int last = min(tile0 + TILE, N) - 1;
    const int hi = band_slab::lower_bound_key_warp(bx, N, band_slab::slab_hi_key(bx, last, radius));
    if (lane == 0) bounds[1] = hi;
  }
  const bool live = q < N;
  float qx = 0.f, qy = 0.f, qz = 0.f;
  if (live) {
    qx = bx[3 * q];
    qy = bx[3 * q + 1];
    qz = bx[3 * q + 2];
  }
  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) acc[k] = NEG;
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];
  const int chunks = (hi - lo + CHUNK - 1) / CHUNK;

  if (chunks > 0) stage<KC, SW>(ring, 0, bx, bu, lo, min(CHUNK, hi - lo), C, c0, cw, vec);
  band_slab::cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int st = k & 1;
    const int base = lo + k * CHUNK;
    if (k + 1 < chunks) {
      stage<KC, SW>(ring, st ^ 1, bx, bu, base + CHUNK, min(CHUNK, hi - base - CHUNK), C, c0, cw,
                    vec);
    }
    band_slab::cp_async_commit();
    band_slab::cp_async_wait_one();  // this thread's copies of chunk k have landed
    __syncthreads();                 // and everyone's
    const int n = min(CHUNK, hi - base);
    for (int j = sw; j < n; j += SW) {
      const float4 p = ring.x[st][j];
      const bool hit = live && band_slab::in_radius(p.x, p.y, p.z, qx, qy, qz, r2);
      if (__any_sync(0xffffffffu, hit)) {
        const float4* row = &ring.u[st][j * (KC / 4)];
#pragma unroll
        for (int k4 = 0; k4 < KC / 4; ++k4) {
          const float4 v = row[k4];
          if (hit) {
            acc[4 * k4] = fmaxf(acc[4 * k4], v.x);
            acc[4 * k4 + 1] = fmaxf(acc[4 * k4 + 1], v.y);
            acc[4 * k4 + 2] = fmaxf(acc[4 * k4 + 2], v.z);
            acc[4 * k4 + 3] = fmaxf(acc[4 * k4 + 3], v.w);
          }
        }
      }
    }
    __syncthreads();  // everyone is done with stage st before it is refilled
  }

  // merge the shares' maxima (the ring is free now) and write whole rows
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int k = 0; k < KC; ++k) red[(sw * TILE + lane) * (KC + 1) + k] = acc[k];
  __syncthreads();
  const int rows = min(TILE, N - tile0);
  for (int i = threadIdx.x; i < rows * cw; i += S::THREADS) {
    const int r = i / cw, k = i - r * cw;
    float m = red[r * (KC + 1) + k];
#pragma unroll
    for (int w = 1; w < SW; ++w) m = fmaxf(m, red[(w * TILE + r) * (KC + 1) + k]);
    out[(static_cast<size_t>(b) * N + tile0 + r) * C + c0 + k] = m;
  }
}

template <int KC, int SW>
int launch(const float* xyz, const float* u, float* out, int B, int N, int C, float radius,
           float r2, cudaStream_t stream) {
  using S = Shape<KC, SW>;
  auto kernel = band_max_kernel<KC, SW>;
  if (S::SMEM > 48 * 1024) {  // above 48 KB only once allowed, per card
    static unsigned allowed = 0;  // a bit per card
    int dev = 0;
    cudaError_t err = cudaGetDevice(&dev);
    if (err != cudaSuccess) return static_cast<int>(err);
    if (dev >= 32 || !(allowed & (1u << dev))) {
      err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, S::SMEM);
      if (err != cudaSuccess) return static_cast<int>(err);
      if (dev < 32) allowed |= 1u << dev;
    }
  }
  const dim3 grid((N + TILE - 1) / TILE, (C + KC - 1) / KC, B);
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(xyz, u, out, N, C, radius, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. xyz [B, N, 3], u and out [B, N, C], all
// contiguous float32 on the current device, any C >= 1; radius and
// r2 = f32(radius**2). Returns the cudaError_t of the launch (0 on success).
extern "C" int band_max_f32(const float* xyz, const float* u, float* out, int B,
                            int N, int C, float radius, float r2, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // 4 warps a tile at 16 channels, 8 above (the fastest on the serving and
  // the cascade's clouds; PERF.md §6)
  if (C <= 16) return launch<16, 4>(xyz, u, out, B, N, C, radius, r2, s);
  if (C <= 32) return launch<32, 8>(xyz, u, out, B, N, C, radius, r2, s);
  return launch<64, 8>(xyz, u, out, B, N, C, radius, r2, s);
}

// Message for an error code returned above.
extern "C" const char* band_max_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
