// Backward of the banded masked max-pool: kernel K2 of the port.
//
//   grad_u[b, n, c] = sum over q with |x_n - x_q|^2 <= r^2 of
//                     g[b, q, c] * [u[b, n, c] == out[b, q, c]]
//
// Every point tied at a query's max receives that query's full cotangent, as
// in the TPU kernel and the JAX custom VJP. Replaces the TPU kernel
// deepvcp_tpu/ops/pallas/band_max_kernel.py::banded_masked_max_grad
// (_band_max_grad_kernel). It ports what that kernel computes, not Mosaic's
// layout: no [B, C, N] transpose, no (8, 128) padding, no scalar prefetch,
// and no clamped last chunk: each query of the slab is visited exactly once.
//
// Design. K1's transpose, with K1's levers (band_max.cu). One block per tile
// of 32 consecutive sorted RECEIVERS n and window of KC channels (KC = 16
// for C <= 16, else 32; a wider C takes several windows, blockIdx.y). The
// in-radius relation is symmetric, so the queries that can see the tile
// form the same slab K1 would pool for it (band_slab.cuh).
//   - A lane owns one receiver and keeps u[n, window] and the window's KC
//     sums in registers, so each (receiver, query) pair is tested once.
//   - Slab search: warp 0 finds lo and warp 1 hi by the warp-cooperative
//     search of band_slab.cuh.
//   - Staging: the slab's xyz and its out and g window rows stream through a
//     two-stage cp.async ring of CHUNK = 128 points, so the next chunk loads
//     while the current one is tested.
//   - Split: SW = 8 warps take interleaved points of each chunk. A point's
//     rows are read (broadcasts) only where a ballot finds some lane in
//     radius, a warp-uniform branch; inside it each channel's compare and
//     add is one predicated PTX add, with no per-lane branch (nvcc's
//     branches there made every 4 channels wait on their own shared-memory
//     loads).
//   - Merge: each warp's sums go to shared memory and the block adds them in
//     warp order, then writes whole rows.
// Reading only the rows a ballot asks for, straight from global memory, and
// windows of 64 channels were slower on every shape (PERF.md, section 6).
//
// Determinism. Each warp sums its points in ascending q and the warps' sums
// are added in a fixed order, with no atomics: the same inputs give the same
// bits. Integer-valued cotangents sum exactly, as in the plain version.
//
// Any C >= 1: a window's channels past C are staged from nowhere and never
// written; C % 4 == 0 stages and writes 16-byte pieces, other C 4-byte
// elements.
//
// What bounds it. At the serving shapes (slabs of 120-385 points a tile,
// 1-2% of the tested pairs in radius), latency: the search, the ring's first
// chunk and few points a warp. On the object-scale clouds of the cascade
// (slabs of thousands of points, up to 64% of the pairs in radius), issue:
// two instructions per channel for every tested pair of a point that some
// lane of the warp has in radius.

#include <cuda_runtime.h>

#include "band_slab.cuh"

namespace {

constexpr int TILE = 32;    // receivers per block, a lane each
constexpr int CHUNK = 128;  // slab points per stage of the ring
constexpr int SW = 8;       // warps a block, each taking every SW-th point of a chunk

// A block over one tile of 32 receivers and a window of KC channels.
// Dynamic shared memory holds the ring, then the merge.
template <int KC>
struct Shape {
  static constexpr int THREADS = 32 * SW;
  struct Ring {
    float4 x[2][CHUNK];           // xyz of a chunk's points (w unused)
    float4 o[2][CHUNK * KC / 4];  // their out rows' window, row-major
    float4 g[2][CHUNK * KC / 4];  // their g rows' window
  };
  static constexpr int MERGE = SW * TILE * (KC + 1) * 4;
  static constexpr int SMEM = sizeof(Ring) > MERGE ? sizeof(Ring) : MERGE;
};

// acc += g where hit and un == o, as a predicated add. In PTX so that no
// branch on the lane's hit appears: nvcc otherwise branches per 4 channels
// and each branch waits on its own shared-memory loads.
__device__ __forceinline__ void add_if(float& acc, float un, float o, float g, unsigned hit) {
  asm("{\n\t.reg .pred h, p;\n\t"
      "setp.ne.u32 h, %4, 0;\n\t"
      "setp.eq.and.f32 p, %1, %2, h;\n\t"
      "@p add.rn.f32 %0, %0, %3;\n\t}"
      : "+f"(acc) : "f"(un), "f"(o), "f"(g), "r"(hit));
}

// add_if over the window's KC channels of one staged query row.
template <int KC>
__device__ __forceinline__ void add_row(float (&acc)[KC], const float (&un)[KC], unsigned hit,
                                        const float4* orow, const float4* grow) {
#pragma unroll
  for (int k4 = 0; k4 < KC / 4; ++k4) {
    const float4 o = orow[k4];
    const float4 gv = grow[k4];
    add_if(acc[4 * k4], un[4 * k4], o.x, gv.x, hit);
    add_if(acc[4 * k4 + 1], un[4 * k4 + 1], o.y, gv.y, hit);
    add_if(acc[4 * k4 + 2], un[4 * k4 + 2], o.z, gv.z, hit);
    add_if(acc[4 * k4 + 3], un[4 * k4 + 3], o.w, gv.w, hit);
  }
}

template <int KC>
__global__ void __launch_bounds__(Shape<KC>::THREADS)
band_max_grad_kernel(const float* __restrict__ xyz, const float* __restrict__ u,
                     const float* __restrict__ out, const float* __restrict__ g,
                     float* __restrict__ grad, int N, int C, float radius, float r2) {
  using S = Shape<KC>;
  extern __shared__ float4 smem[];
  typename S::Ring& ring = *reinterpret_cast<typename S::Ring*>(smem);
  __shared__ int bounds[2];

  const int b = blockIdx.z;
  const int tile0 = blockIdx.x * TILE;
  const int c0 = blockIdx.y * KC;
  const int cw = min(KC, C - c0);
  const bool vec = C % 4 == 0 &&
      ((reinterpret_cast<size_t>(u) | reinterpret_cast<size_t>(out) |
        reinterpret_cast<size_t>(g) | reinterpret_cast<size_t>(grad)) % 16) == 0;
  const int lane = threadIdx.x & 31;
  const int sw = threadIdx.x >> 5;  // which share of each chunk
  const int n = tile0 + lane;
  const float* bx = xyz + static_cast<size_t>(b) * N * 3;
  const float* bo = out + static_cast<size_t>(b) * N * C;
  const float* bg = g + static_cast<size_t>(b) * N * C;

  if (sw == 0) {
    const int lo = band_slab::lower_bound_key_warp(bx, N, band_slab::slab_lo_key(bx, tile0, radius));
    if (lane == 0) bounds[0] = lo;
  } else if (sw == 1) {
    const int last = min(tile0 + TILE, N) - 1;
    const int hi = band_slab::lower_bound_key_warp(bx, N, band_slab::slab_hi_key(bx, last, radius));
    if (lane == 0) bounds[1] = hi;
  }
  const bool live = n < N;
  float nx = 0.f, ny = 0.f, nz = 0.f;
  float un[KC];
  float acc[KC];
#pragma unroll
  for (int k = 0; k < KC; ++k) {
    un[k] = 0.f;
    acc[k] = 0.f;
  }
  if (live) {
    nx = bx[3 * n];
    ny = bx[3 * n + 1];
    nz = bx[3 * n + 2];
    const float* row = u + (static_cast<size_t>(b) * N + n) * C + c0;
    if (vec) {
#pragma unroll
      for (int k4 = 0; k4 < KC / 4; ++k4) {
        if (4 * k4 < cw) {
          const float4 v = __ldg(reinterpret_cast<const float4*>(row) + k4);
          un[4 * k4] = v.x;
          un[4 * k4 + 1] = v.y;
          un[4 * k4 + 2] = v.z;
          un[4 * k4 + 3] = v.w;
        }
      }
    } else {
#pragma unroll
      for (int k = 0; k < KC; ++k) {
        if (k < cw) un[k] = __ldg(row + k);
      }
    }
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];
  const int chunks = (hi - lo + CHUNK - 1) / CHUNK;

  // stage points [base, base + m) of the slab into ring stage st
  auto stage = [&](int st, int base, int m) {
    band_slab::stage_xyz<S::THREADS>(ring.x[st], bx, base, m);
    band_slab::stage_window<KC, S::THREADS>(ring.o[st], bo, base, m, C, c0, cw, vec);
    band_slab::stage_window<KC, S::THREADS>(ring.g[st], bg, base, m, C, c0, cw, vec);
  };
  if (chunks > 0) stage(0, lo, min(CHUNK, hi - lo));
  band_slab::cp_async_commit();
  for (int k = 0; k < chunks; ++k) {
    const int st = k & 1;
    const int base = lo + k * CHUNK;
    if (k + 1 < chunks) stage(st ^ 1, base + CHUNK, min(CHUNK, hi - base - CHUNK));
    band_slab::cp_async_commit();
    band_slab::cp_async_wait_one();  // this thread's copies of chunk k have landed
    __syncthreads();                 // and everyone's
    const int m = min(CHUNK, hi - base);
    const float4* xs = ring.x[st];
    const float4* os = ring.o[st];
    const float4* gs = ring.g[st];
    for (int j = sw; j < m; j += SW) {
      const float4 p = xs[j];
      const bool hit = live && band_slab::in_radius(p.x, p.y, p.z, nx, ny, nz, r2);
      if (__any_sync(0xffffffffu, hit)) {
        add_row<KC>(acc, un, hit, os + j * (KC / 4), gs + j * (KC / 4));
      }
    }
    __syncthreads();  // everyone is done with stage st before it is refilled
  }

  // merge the shares' sums in warp order (the ring is free now) and write
  // whole rows
  float* red = reinterpret_cast<float*>(smem);
#pragma unroll
  for (int k = 0; k < KC; ++k) red[(sw * TILE + lane) * (KC + 1) + k] = acc[k];
  __syncthreads();
  const int rows = min(TILE, N - tile0);
  float* bgrad = grad + (static_cast<size_t>(b) * N + tile0) * C + c0;
  if (vec) {
    const int per_row = cw / 4;
    for (int i = threadIdx.x; i < rows * per_row; i += S::THREADS) {
      const int r = i / per_row, k = 4 * (i - r * per_row);
      float v[4];
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        v[e] = red[r * (KC + 1) + k + e];
#pragma unroll
        for (int w = 1; w < SW; ++w) v[e] += red[(w * TILE + r) * (KC + 1) + k + e];
      }
      *reinterpret_cast<float4*>(bgrad + static_cast<size_t>(r) * C + k) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
    for (int i = threadIdx.x; i < rows * cw; i += S::THREADS) {
      const int r = i / cw, k = i - r * cw;
      float v = red[r * (KC + 1) + k];
#pragma unroll
      for (int w = 1; w < SW; ++w) v += red[(w * TILE + r) * (KC + 1) + k];
      bgrad[static_cast<size_t>(r) * C + k] = v;
    }
  }
}

template <int KC>
int launch(const float* xyz, const float* u, const float* out, const float* g, float* grad,
           int B, int N, int C, float radius, float r2, cudaStream_t stream) {
  using S = Shape<KC>;
  auto kernel = band_max_grad_kernel<KC>;
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
  kernel<<<grid, S::THREADS, S::SMEM, stream>>>(xyz, u, out, g, grad, N, C, radius, r2);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. xyz [B, N, 3]; u, out, g and grad
// [B, N, C], all contiguous float32 on the current device, any C >= 1;
// radius and r2 = f32(radius**2), the values the forward (band_max_f32)
// was given. Returns the cudaError_t of the launch (0 on success).
extern "C" int band_max_grad_f32(const float* xyz, const float* u, const float* out,
                                 const float* g, float* grad, int B, int N, int C,
                                 float radius, float r2, void* stream) {
  if (B <= 0 || N <= 0 || C <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // windows of 16 channels at C <= 16, of 32 above (at C = 64 two windows
  // of 32 beat one of 64: PERF.md, section 6)
  if (C <= 16) return launch<16>(xyz, u, out, g, grad, B, N, C, radius, r2, s);
  return launch<32>(xyz, u, out, g, grad, B, N, C, radius, r2, s);
}
