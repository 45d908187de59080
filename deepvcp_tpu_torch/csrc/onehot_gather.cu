// Row gather from per-keypoint tables and its backward: kernels K4 and K5
// of the port.
//
//   K4  out[bk, q, :]    = table[bk, idx[bk, q], :]
//   K5  dtable[bk, t, :] = sum over q with idx[bk, q] == t of dout[bk, q, :]
//
// bk runs over batch x keypoints, q over the C*k candidate neighbours of a
// keypoint, t over the T rows of its table. The last stage of the
// two-level candidate grouping (ops/two_level.py). K4 replaces the TPU
// kernel deepvcp_tpu/ops/pallas/onehot_gather.py::onehot_gather and K5 its
// backward, _scatter_add of the same file. On the TPU both are a one-hot
// [T, bq] matrix times the table on the MXU, padded to Mosaic's (8, 128)
// tiles with D padded to 128 lanes: a way to gather without indexed loads.
// Hopper has indexed loads, so neither kernel builds a one-hot matrix.
//
// K4 design. One block per (bk, 256 queries). The block reads its 256
// indices into shared memory, then its threads walk the flat [256 * D]
// span of the output: neighbouring threads write neighbouring floats (a
// 35-float row is 140 bytes, not 16-byte aligned, so rows are not stored
// as vectors) and read neighbouring floats of one table row through the
// read-only cache (__ldg): a keypoint's table is 71 680 bytes at T = 512,
// D = 35, and all tables together (4.6 MB) sit in L2. A copy, so the output
// is bit-identical to torch.gather. An index outside [0, T) gives a row of
// NaN (torch.gather would raise; checking would cost the wrapper a host
// synchronisation).
//
// K5 design, deterministic, with no atomics in global memory. One block per
// (bk, 64 table rows). The block sorts the keypoint's Q indices that fall
// in its rows by a stable counting sort in shared memory: each of the 8
// warps owns a contiguous eighth of q and counts its entries per row
// (shared-memory integer atomics: exact counts); an exclusive scan over
// the rows gives each row's start and each warp its own cursor per row;
// then each warp walks its eighth in ascending chunks of 32, where
// __match_any_sync gives each lane its rank among the lanes of the chunk
// with the same row, and the group's leader advances the warp's cursor.
// The list so built holds each row's q in ascending order. Then each thread
// owns (row, channel) outputs and sums its row's list in that order,
// starting from 0, as ops/kernels/onehot_gather.py's plain version does:
// the same bits, run after run. An index outside [0, T) adds to no row.
//
// What bounds them. Bytes: K4 reads the indices (8 bytes each) and the
// table and writes Q * D floats; K5 reads dout and the indices and writes
// the tables; each does at most one add per dout element. At the path's
// shapes (64 keypoints, Q = 6912, T = 512, D = 35) about 70 MB each: 21 us
// at 3.35 TB/s. K5 also re-reads its keypoint's indices once per 64 rows
// (from L2) and spends a few microseconds on the sort before it sums.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;
constexpr int GATHER_QUERIES = 256;  // K4: queries per block
constexpr int SCATTER_ROWS = 64;     // K5: table rows per block
static_assert(SCATTER_ROWS % 32 == 0 && SCATTER_ROWS <= THREADS, "scan layout");

__global__ void __launch_bounds__(THREADS)
onehot_gather_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                     float* __restrict__ out, int T, int Q, int D) {
  __shared__ int s_idx[GATHER_QUERIES];
  const size_t bk = blockIdx.x;
  const int q0 = blockIdx.y * GATHER_QUERIES;
  const int rows = min(GATHER_QUERIES, Q - q0);
  const long long* bidx = idx + bk * Q + q0;
  for (int i = threadIdx.x; i < rows; i += THREADS) {
    const long long t = bidx[i];
    s_idx[i] = (t >= 0 && t < T) ? static_cast<int>(t) : -1;
  }
  __syncthreads();
  const float* btab = table + bk * T * D;
  float* bout = out + (bk * Q + q0) * D;
  const int n = rows * D;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const int r = p / D;
    const int t = s_idx[r];
    bout[p] = t >= 0 ? __ldg(btab + static_cast<size_t>(t) * D + (p - r * D)) : CUDART_NAN_F;
  }
}

__global__ void __launch_bounds__(THREADS)
onehot_scatter_add_kernel(const float* __restrict__ dout, const long long* __restrict__ idx,
                          float* __restrict__ dtable, int T, int Q, int D) {
  extern __shared__ int s_list[];               // [Q]: q grouped by row, ascending
  __shared__ int s_cur[WARPS][SCATTER_ROWS];    // counts, then each warp's cursors
  __shared__ int s_start[SCATTER_ROWS + 1];
  __shared__ int s_wsum[SCATTER_ROWS / 32];

  const size_t bk = blockIdx.x;
  const int t0 = blockIdx.y * SCATTER_ROWS;
  const int nrows = min(SCATTER_ROWS, T - t0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long* bidx = idx + bk * Q;
  const int seg = (Q + WARPS - 1) / WARPS;
  const int q_lo = min(Q, warp * seg);
  const int q_hi = min(Q, q_lo + seg);

  for (int i = threadIdx.x; i < WARPS * SCATTER_ROWS; i += THREADS) {
    (&s_cur[0][0])[i] = 0;
  }
  __syncthreads();

  // 1. each warp counts its eighth's entries per row of this block
  for (int q = q_lo + lane; q < q_hi; q += 32) {
    const long long t = bidx[q];
    if (t >= t0 && t < t0 + nrows) atomicAdd(&s_cur[warp][t - t0], 1);
  }
  __syncthreads();

  // 2. exclusive scan of the row totals; warp w's cursor for a row starts
  // after the entries of warps < w in that row
  const int r = threadIdx.x;
  int total = 0;
  if (r < SCATTER_ROWS) {
    for (int w = 0; w < WARPS; ++w) total += s_cur[w][r];
  }
  int incl = total;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int v = __shfl_up_sync(FULL, incl, off);
    if (lane >= off) incl += v;
  }
  if (r < SCATTER_ROWS && lane == 31) s_wsum[warp] = incl;
  __syncthreads();
  if (r < SCATTER_ROWS) {
    int before = 0;
    for (int w = 0; w < warp; ++w) before += s_wsum[w];
    int run = before + incl - total;
    s_start[r] = run;
    if (r == SCATTER_ROWS - 1) s_start[SCATTER_ROWS] = before + incl;
    for (int w = 0; w < WARPS; ++w) {
      const int c = s_cur[w][r];
      s_cur[w][r] = run;
      run += c;
    }
  }
  __syncthreads();

  // 3. stable placement: chunks of 32 in ascending q, ranks among equal rows
  for (int base = q_lo; base < q_hi; base += 32) {
    const int q = base + lane;
    const long long t = q < q_hi ? bidx[q] : -1;
    const bool mine = t >= t0 && t < t0 + nrows;
    const int key = mine ? static_cast<int>(t - t0) : -1;
    const unsigned group = __match_any_sync(FULL, key);
    const int leader = __ffs(group) - 1;
    int pos = 0;
    if (mine && lane == leader) {
      pos = s_cur[warp][key];
      s_cur[warp][key] = pos + __popc(group);
    }
    pos = __shfl_sync(FULL, pos, leader);
    if (mine) s_list[pos + __popc(group & ((1u << lane) - 1u))] = q;
  }
  __syncthreads();

  // 4. each (row, channel) output sums its row's list in ascending q; the
  // loads of four terms are issued before they are added, in order
  const float* bd = dout + bk * Q * D;
  float* bt = dtable + (bk * T + t0) * D;
  const int n = nrows * D;
  for (int p = threadIdx.x; p < n; p += THREADS) {
    const int row = p / D;
    const int d = p - row * D;
    const int e = s_start[row + 1];
    int j = s_start[row];
    float acc = 0.f;
    for (; j + 4 <= e; j += 4) {
      const float a = __ldg(bd + static_cast<size_t>(s_list[j]) * D + d);
      const float b = __ldg(bd + static_cast<size_t>(s_list[j + 1]) * D + d);
      const float c = __ldg(bd + static_cast<size_t>(s_list[j + 2]) * D + d);
      const float f = __ldg(bd + static_cast<size_t>(s_list[j + 3]) * D + d);
      acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, a), b), c), f);
    }
    for (; j < e; ++j) acc = __fadd_rn(acc, __ldg(bd + static_cast<size_t>(s_list[j]) * D + d));
    bt[p] = acc;
  }
}

}  // namespace

// Plain C entry points for ctypes. table/dtable [BK, T, D], idx [BK, Q]
// int64, out/dout [BK, Q, D], all contiguous on the current device, float32
// unless said otherwise; BK, T, Q, D >= 1, Q <= 65535 * 256 (K4) and
// Q * 4 bytes within a block's shared memory (K5). Each returns the
// cudaError_t of its launch (0 on success).
extern "C" int onehot_gather_f32(const float* table, const long long* idx, float* out, int BK,
                                 int T, int Q, int D, void* stream) {
  if (BK <= 0 || T <= 0 || Q <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BK, (Q + GATHER_QUERIES - 1) / GATHER_QUERIES);
  onehot_gather_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      table, idx, out, T, Q, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int onehot_scatter_add_f32(const float* dout, const long long* idx, float* dtable,
                                      int BK, int T, int Q, int D, void* stream) {
  if (BK <= 0 || T <= 0 || Q <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = static_cast<size_t>(Q) * sizeof(int);
  if (smem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        onehot_scatter_add_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid(BK, (T + SCATTER_ROWS - 1) / SCATTER_ROWS);
  onehot_scatter_add_kernel<<<grid, THREADS, smem, static_cast<cudaStream_t>(stream)>>>(
      dout, idx, dtable, T, Q, D);
  return static_cast<int>(cudaGetLastError());
}
