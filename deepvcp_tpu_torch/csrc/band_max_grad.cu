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
// and no clamped last chunk, so nothing is re-read and nothing has to be
// zeroed: each query of the slab is visited exactly once.
//
// Design. The transpose of K1: one block per tile of TILE consecutive sorted
// RECEIVERS n. The in-radius relation is symmetric, so the queries that can
// see the tile form the same slab K1 would pool for it (band_slab.cuh). The
// block streams that slab's xyz, out and g through shared memory CHUNK
// queries at a time. A thread owns one receiver and KPT channels, keeps
// u[n, k] and the KPT sums in registers, and adds g[q, k] wherever the pair
// is in radius and u[n, k] == out[q, k]. Threads of one warp share their
// channel group, so each shared-memory read of a query row is a broadcast.
//
// Determinism. Each sum runs over the slab in ascending q, one thread per
// (n, channel group), with no atomics: the same inputs give the same bits.
//
// Any C >= 1: a block takes a window of CB channels (CB = 16, 32 or 64, a
// template parameter; C = 16, 32 and 64 are one window each, and a wider or
// other C takes ceil(C / CB) windows, blockIdx.z). A window's channels past
// C are staged as zeros and never written.
//
// What bounds it. Like K1, shared-memory reads and compare-and-add on
// in-radius pairs; each query row (3 + 2 C floats) crosses HBM once per
// receiver tile. A chunk is CHUNK * (3 + 2 CB) * 4 bytes: 33.5 KB at CB =
// 64, inside the 48 KB a block may declare statically.

#include <cuda_runtime.h>

#include "band_slab.cuh"

namespace {

constexpr int TILE = 64;   // receivers per block
constexpr int CHUNK = 64;  // queries staged in shared memory per step
constexpr int KPT = 16;    // channels per thread; C / KPT threads share a receiver

template <int CB>
__global__ void __launch_bounds__(TILE * (CB / KPT))
band_max_grad_kernel(const float* __restrict__ xyz, const float* __restrict__ u,
                     const float* __restrict__ out, const float* __restrict__ g,
                     float* __restrict__ grad, int N, int C, float radius, float r2) {
  static_assert(CB % KPT == 0, "CB must be a multiple of KPT");
  __shared__ float sx[CHUNK * 3];
  __shared__ __align__(16) float so[CHUNK * CB];
  __shared__ __align__(16) float sg[CHUNK * CB];
  __shared__ int bounds[2];

  const int b = blockIdx.y;
  const int tile0 = blockIdx.x * TILE;
  const int c0 = blockIdx.z * CB;
  const int cw = min(CB, C - c0);  // == CB == C on the SA stages' widths
  const int n = tile0 + threadIdx.x % TILE;
  const int group = threadIdx.x / TILE;
  const float* bx = xyz + static_cast<size_t>(b) * N * 3;
  const float* bo = out + static_cast<size_t>(b) * N * C;
  const float* bg = g + static_cast<size_t>(b) * N * C;

  if (threadIdx.x == 0) {
    band_slab::slab(bx, N, tile0, TILE, radius, &bounds[0], &bounds[1]);
  }
  __syncthreads();
  const int lo = bounds[0];
  const int hi = bounds[1];

  const bool live = n < N;
  float nx = 0.f, ny = 0.f, nz = 0.f;
  float un[KPT];
  float acc[KPT];
#pragma unroll
  for (int k = 0; k < KPT; ++k) un[k] = 0.f;
  if (live) {
    nx = bx[3 * n];
    ny = bx[3 * n + 1];
    nz = bx[3 * n + 2];
    const float* row = u + (static_cast<size_t>(b) * N + n) * C + c0 + group * KPT;
    if (C == CB && reinterpret_cast<size_t>(row) % 16 == 0) {
      const float4* row4 = reinterpret_cast<const float4*>(row);
#pragma unroll
      for (int k = 0; k < KPT / 4; ++k) {
        const float4 v = row4[k];
        un[4 * k] = v.x;
        un[4 * k + 1] = v.y;
        un[4 * k + 2] = v.z;
        un[4 * k + 3] = v.w;
      }
    } else {
#pragma unroll
      for (int k = 0; k < KPT; ++k) {
        if (group * KPT + k < cw) un[k] = row[k];
      }
    }
  }
#pragma unroll
  for (int k = 0; k < KPT; ++k) acc[k] = 0.f;

  for (int base = lo; base < hi; base += CHUNK) {
    const int m = min(CHUNK, hi - base);
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < m * 3; i += blockDim.x) {
      sx[i] = bx[static_cast<size_t>(base) * 3 + i];
    }
    if (C == CB) {  // the window is the whole row: one contiguous copy
      for (int i = threadIdx.x; i < m * CB; i += blockDim.x) {
        so[i] = bo[static_cast<size_t>(base) * C + i];
        sg[i] = bg[static_cast<size_t>(base) * C + i];
      }
    } else {
      for (int i = threadIdx.x; i < m * CB; i += blockDim.x) {
        const int r = i / CB, k = i % CB;
        const size_t at = static_cast<size_t>(base + r) * C + c0 + k;
        so[i] = k < cw ? bo[at] : 0.f;
        sg[i] = k < cw ? bg[at] : 0.f;
      }
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < m; ++j) {
      if (band_slab::in_radius(sx[3 * j], sx[3 * j + 1], sx[3 * j + 2], nx, ny, nz, r2)) {
        const float4* orow = reinterpret_cast<const float4*>(so + j * CB + group * KPT);
        const float4* grow = reinterpret_cast<const float4*>(sg + j * CB + group * KPT);
#pragma unroll
        for (int k = 0; k < KPT / 4; ++k) {
          const float4 o = orow[k];
          const float4 gv = grow[k];
          if (un[4 * k] == o.x) acc[4 * k] += gv.x;
          if (un[4 * k + 1] == o.y) acc[4 * k + 1] += gv.y;
          if (un[4 * k + 2] == o.z) acc[4 * k + 2] += gv.z;
          if (un[4 * k + 3] == o.w) acc[4 * k + 3] += gv.w;
        }
      }
    }
  }
  if (live) {
    float* o = grad + (static_cast<size_t>(b) * N + n) * C + c0 + group * KPT;
#pragma unroll
    for (int k = 0; k < KPT; ++k) {
      if (group * KPT + k < cw) o[k] = acc[k];
    }
  }
}

template <int CB>
int launch(const float* xyz, const float* u, const float* out, const float* g,
           float* grad, int B, int N, int C, float radius, float r2, cudaStream_t stream) {
  const dim3 grid((N + TILE - 1) / TILE, B, (C + CB - 1) / CB);
  band_max_grad_kernel<CB><<<grid, TILE * (CB / KPT), 0, stream>>>(
      xyz, u, out, g, grad, N, C, radius, r2);
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
  if (C <= 16) return launch<16>(xyz, u, out, g, grad, B, N, C, radius, r2, s);
  if (C <= 32) return launch<32>(xyz, u, out, g, grad, B, N, C, radius, r2, s);
  return launch<64>(xyz, u, out, g, grad, B, N, C, radius, r2, s);
}
