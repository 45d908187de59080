// The k <= 32 nearest points of each query, with the distance tile kept on
// chip: kernel K6 of the port, in two arms that differ only in the key a
// list is ordered by.
//
// The f32 arm (knn_select_f32):
//
//   out[b, m, :] = the k points n of pair b with the smallest
//                  (d2[b, m, n], n), and their d2, where
//   d2[b, m, n]  = max((s2[b, m] + r2[b, n]) - 2 (q[b, m] . p[b, n]), 0)
//
// the squared distance as ops/distance.py::square_distance forms it, with
// s2 and r2 (the squared norms) computed by the wrapper with its PyTorch
// ops.
//
// The bf16 arm (knn_select_bf16) selects on approx_knn's bf16 selection
// tile: q and p are the centred coordinates rounded to bf16 (passed as f32),
// s2 and r2 the norms of the unrounded centred coordinates, and
//
//   d2[b, m, n]  = bf16_rn((s2[b, m] + r2[b, n]) - 2 (q[b, m] . p[b, n]))
//
// with no clamp: with rounded coordinates near points often have a negative
// d2, and their order below zero decides the list. It selects on the key
// torch.topk's radix select compares: the bf16 bits mapped to an ordered
// 16-bit key (a negative value's bits inverted, a positive value's sign bit
// set), which puts -0 below +0. The list holds key << 16 | n in one 32-bit
// register a lane (n < 65 536), so one unsigned compare orders by (key,
// index).
//
// In both arms a tie at the k-th key goes to the lower index, as
// torch.topk's radix select on the card takes the first seen. The set is
// written in torch.topk's layout before its sort (below the k-th key in
// ascending index, then the ties at the k-th), and the wrapper sorts it
// with the same torch.sort, so the list equals torch.topk's of the tile bit
// for bit, its order within equal distances included: the registrar's later
// stages sum over the list in its order, and in the three guarded
// refinements of kitti25-rot an ulp there grew to 0.04 deg of pose
// (PERF.md, K6).
//
// It replaces no TPU kernel: the JAX package selects with XLA's
// jax.lax.approx_min_k (deepvcp_tpu/ops/knn.py:117), and the port's plain
// versions build the [B, M, N] tile (f32, or f32 then bf16) and run
// torch.topk over it (1.47 GB of f32 a 4 608-query chunk at B = 8, with
// temporaries of the same size, and several radix passes). It was added
// for speed: the flat candidate KNN (13 824 queries x 10 000 points a pair
// in f32 for kitti25-rot, 21 952 on the bf16 tile for lidar-fine) was most
// of a batched call's device time.
//
// What bounds it: compares, on the CUDA cores. At B = 8 a stage is 1.1e9
// (kitti25-rot) or 1.8e9 (lidar-fine) (query, point) pairs of ~10
// operations and reads a few MB; no tile reaches device memory, only the
// [B, M, k] result.
//
// Design. A warp owns a query and keeps its running top-32 as a sorted list
// across the lanes: lane i holds the i-th smallest (key, index). The points
// stream through shared memory in chunks of 1 024 (x, y, z, r2), a
// two-stage cp.async ring shared by the block's warps; each lane takes one
// point of a group of 32, and a ballot of key < the k-th stored key picks
// the candidates. Each candidate is inserted in lane order by one shuffle
// up of the list's tail, so no lane ever waits for another's branch: the
// lanes of a warp work on one query, whose 32 candidates share one fate
// only in the ballot. After the first groups a query meets few candidates
// (about k (1 + ln(N / k)) inserts in all over points in random order), so
// most groups are the product, a compare and one ballot. A warp sees its
// points in ascending index, so a candidate sorts after every stored entry
// of equal key: inserting it behind them and refusing one equal to the
// k-th keeps the lower index (in the bf16 arm the packed index makes the
// same strict compare). The same warp a query serves the source KNN's 64
// keypoints a pair, where the card holds few warps.
//
// The product is the chain fma(z, z', fma(y, y', x * x')), in the order of
// the k loop of cuBLAS's f32 GEMM (TF32 off, as the port runs): the d2
// values then equal the tile's bit for bit at the path's shapes
// (chip_smoke.py phases 26 and 27). In the bf16 arm each product of two
// bf16 values is exact in f32, so only the order of the two additions
// counts. cuBLAS takes other kernels for a single query, and for up to 16
// queries against up to 1 000 points at B = 1 (products summed without
// FMAs): there an f32 element may differ by an ulp (PERF.md, K6). -2 *
// cross is exact, so fma(-2, cross, s2 + r2) rounds once, as the tile's
// subtraction does. Every (query, point) pair is evaluated: no spatial
// culling.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

#include "band_slab.cuh"

namespace {

constexpr unsigned FULL = 0xffffffffu;
constexpr int WARPS = 8;
constexpr int THREADS = 32 * WARPS;
constexpr int CHUNK = 1024;   // points a stage of the ring
constexpr int KMAX = 32;      // the list: one entry a lane
constexpr int NO_INDEX = INT_MAX;
constexpr int BF16_MAX_N = 1 << 16;  // the bf16 arm's index field

// Stage points [base, base + n) of one pair as (x, y, z, r2)
__device__ __forceinline__ void stage(float4* dst, const float* bref, const float* br2, int base,
                                      int n) {
  band_slab::stage_xyz<THREADS>(dst, bref, base, n);
  float* sd = reinterpret_cast<float*>(dst);
  for (int i = threadIdx.x; i < n; i += THREADS) band_slab::cp_async4(sd + 4 * i + 3, br2 + base + i);
}

// torch.topk's layout of the set before its sort: the position of this
// lane's entry (key, index) of the sorted list among the entries below the
// k-th key in ascending index, then those equal to it
template <class Key>
__device__ __forceinline__ int topk_position(Key key, int index, Key kth, int k) {
  const bool below = key < kth;
  int pos = 0;
#pragma unroll
  for (int l = 0; l < KMAX; ++l) {
    const Key kl = __shfl_sync(FULL, key, l);
    const int il = __shfl_sync(FULL, index, l);
    pos += l < k && (below ? (kl < kth && il < index) : (kl < kth || il < index));
  }
  return pos;
}

// The f32 arm's list: (clamped d2, index) in two registers a lane
struct F32List {
  using Out = float;
  float D, thr;
  int I;

  __device__ __forceinline__ void reset() {
    D = thr = CUDART_INF_F;
    I = NO_INDEX;
  }

  // a lane's candidate: its squared distance before the clamp
  __device__ __forceinline__ static float candidate(float d, int) { return d; }

  // Insert the candidates of `cand` (a lane mask of this group) into the
  // sorted list, in lane order; index0 is the group's first point index.
  __device__ __forceinline__ void insert(unsigned cand, float d, int index0, int k, int lane) {
    while (cand) {
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      float cd = __shfl_sync(FULL, d, src);
      cd = cd < 0.0f ? 0.0f : cd;  // clamp_min(., 0)
      if (!(cd < thr)) continue;   // thr moved within the group (warp-uniform)
      // the stored entries that sort after the candidate: every stored index
      // is lower, so those of strictly greater d2, a suffix of the lanes
      const int first = __ffs(__ballot_sync(FULL, cd < D)) - 1;
      const float up_d = __shfl_up_sync(FULL, D, 1);
      const int up_i = __shfl_up_sync(FULL, I, 1);
      if (lane == first) {
        D = cd;
        I = index0 + src;
      } else if (lane > first) {
        D = up_d;
        I = up_i;
      }
      thr = __shfl_sync(FULL, D, k - 1);
    }
  }

  __device__ __forceinline__ void write(float* out_d2, long long* out_idx, size_t row, int k,
                                        int lane, bool in_range) const {
    const int pos = topk_position(D, I, __shfl_sync(FULL, D, k - 1), k);
    if (lane < k && in_range) {
      out_d2[row * k + pos] = D;
      out_idx[row * k + pos] = I;
    }
  }
};

// The bf16 arm's list: key << 16 | index in one register a lane, where key
// is torch.topk's radix key of the bf16 d2
struct Bf16List {
  using Out = unsigned short;
  unsigned P, thr;

  __device__ __forceinline__ void reset() { P = thr = FULL; }

  __device__ __forceinline__ static unsigned candidate(float d, int n) {
    const unsigned bits = __bfloat16_as_ushort(__float2bfloat16_rn(d));
    const unsigned key = (bits & 0x8000u) ? (bits ^ 0xffffu) : (bits | 0x8000u);
    return key << 16 | static_cast<unsigned>(n);
  }

  __device__ __forceinline__ void insert(unsigned cand, unsigned c, int, int k, int lane) {
    while (cand) {
      const int src = __ffs(cand) - 1;
      cand &= cand - 1;
      const unsigned cp = __shfl_sync(FULL, c, src);
      if (!(cp < thr)) continue;  // thr moved within the group (warp-uniform)
      const int first = __ffs(__ballot_sync(FULL, cp < P)) - 1;
      const unsigned up = __shfl_up_sync(FULL, P, 1);
      if (lane == first) {
        P = cp;
      } else if (lane > first) {
        P = up;
      }
      thr = __shfl_sync(FULL, P, k - 1);
    }
  }

  __device__ __forceinline__ void write(unsigned short* out_d2, long long* out_idx, size_t row,
                                        int k, int lane, bool in_range) const {
    const unsigned key = P >> 16;
    const int index = static_cast<int>(P & 0xffffu);
    const int pos = topk_position(key, index, __shfl_sync(FULL, P, k - 1) >> 16, k);
    if (lane < k && in_range) {
      // the key back to the bf16 bits (TopKTypeConfig<BFloat16>::deconvert)
      const unsigned bits = key ^ ((key & 0x8000u) ? 0x8000u : 0xffffu);
      out_d2[row * k + pos] = static_cast<unsigned short>(bits);
      out_idx[row * k + pos] = index;
    }
  }
};

// A block: WARPS warps over one pair, a query each
template <class List>
__global__ void __launch_bounds__(THREADS)
knn_select_kernel(const float* __restrict__ query, const float* __restrict__ qs2,
                  const float* __restrict__ ref, const float* __restrict__ rr2,
                  typename List::Out* __restrict__ out_d2, long long* __restrict__ out_idx,
                  int M, int N, int k) {
  __shared__ __align__(16) float4 ring[2][CHUNK];
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.y;
  const int q = blockIdx.x * WARPS + (threadIdx.x >> 5);
  const int qc = min(q, M - 1);  // a warp past M repeats the last query, unwritten
  const float* bq = query + (static_cast<size_t>(b) * M + qc) * 3;
  const float* bref = ref + static_cast<size_t>(b) * N * 3;
  const float* br2 = rr2 + static_cast<size_t>(b) * N;
  const float qx = bq[0], qy = bq[1], qz = bq[2];
  const float s2 = qs2[static_cast<size_t>(b) * M + qc];
  List list;
  list.reset();

  const int chunks = (N + CHUNK - 1) / CHUNK;
  stage(ring[0], bref, br2, 0, min(CHUNK, N));
  band_slab::cp_async_commit();
  for (int c = 0; c < chunks; ++c) {
    const int base = c * CHUNK, n = min(CHUNK, N - base);
    if (c + 1 < chunks) stage(ring[(c + 1) & 1], bref, br2, base + CHUNK, min(CHUNK, N - base - CHUNK));
    band_slab::cp_async_commit();
    band_slab::cp_async_wait_one();
    __syncthreads();
    const float4* pts = ring[c & 1];
    for (int g = 0; g < n; g += 32) {
      const int p = g + lane;
      const bool valid = p < n;
      const float4 pt = pts[valid ? p : 0];
      // the GEMM's product, then (s2 + r2) - 2 cross rounded once
      const float cross = __fmaf_rn(qz, pt.z, __fmaf_rn(qy, pt.y, __fmul_rn(qx, pt.x)));
      const float d = __fmaf_rn(-2.0f, cross, __fadd_rn(s2, pt.w));
      const auto key = List::candidate(d, base + p);
      const unsigned cand = __ballot_sync(FULL, valid && key < list.thr);
      if (cand) list.insert(cand, key, base + g, k, lane);
    }
    __syncthreads();  // the stage just read is refilled next
  }
  list.write(out_d2, out_idx, static_cast<size_t>(b) * M + q, k, lane, q < M);
}

template <class List>
int launch(const float* query, const float* s2, const float* ref, const float* r2,
           typename List::Out* out_d2, long long* out_idx, int B, int M, int N, int k,
           void* stream) {
  if (B <= 0 || M <= 0 || N <= 0 || B > 65535 || k < 1 || k > KMAX || k > N)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((M + WARPS - 1) / WARPS, B);
  knn_select_kernel<List><<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      query, s2, ref, r2, out_d2, out_idx, M, N, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. query [B, M, 3], s2 [B, M], ref [B, N, 3],
// r2 [B, N], all contiguous float32 on the current device; out_idx int64
// [B, M, k], each row the k smallest (key, index) in torch.topk's layout
// (the wrapper sorts it by d2 as torch.topk does). 1 <= k <= min(32, N).
// Each returns the cudaError_t of the launch (0 on success).

// out_d2 float32 [B, M, k]
extern "C" int knn_select_f32(const float* query, const float* s2, const float* ref,
                              const float* r2, float* out_d2, long long* out_idx, int B, int M,
                              int N, int k, void* stream) {
  return launch<F32List>(query, s2, ref, r2, out_d2, out_idx, B, M, N, k, stream);
}

// query and ref hold bf16 values; out_d2 bfloat16 [B, M, k] (its bits);
// N <= 65 536
extern "C" int knn_select_bf16(const float* query, const float* s2, const float* ref,
                               const float* r2, unsigned short* out_d2, long long* out_idx,
                               int B, int M, int N, int k, void* stream) {
  if (N > BF16_MAX_N) return static_cast<int>(cudaErrorInvalidValue);
  return launch<Bf16List>(query, s2, ref, r2, out_d2, out_idx, B, M, N, k, stream);
}
