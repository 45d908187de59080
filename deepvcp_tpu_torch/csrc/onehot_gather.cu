// Row gather from per-keypoint tables and its backward: kernels K4 and K5
// of the port.
//
//   K4  out[bk, q, :]    = table[bk, idx[bk, q], :]
//   K5  dtable[bk, t, :] = sum over q with idx[bk, q] == t of dout[bk, q, :]
//
// bk runs over batch x keypoints, q over the C*k candidate neighbours of a
// keypoint, t over the T rows of its table. The last stage of the
// two-level candidate grouping (ops/two_level.py). K4 replaces the TPU
// kernel deepvcp_tpu/ops/pallas/onehot_gather.py::onehot_gather (:74) and
// K5 its backward, _scatter_add of the same file (:156). On the TPU both
// are a one-hot [T, bq] matrix times the table on the MXU, padded to
// Mosaic's (8, 128) tiles with D padded to 128 lanes: a way to gather
// without indexed loads. Hopper has indexed loads, so neither kernel builds
// a one-hot matrix.
//
// What bounds them: bytes. At the path's shapes (64 keypoints, Q = 6912,
// T = 512, D = 35) K4 writes 61.9 MB and reads 4.6 MB of tables and 3.5 MB
// of indices; K5 reads the same 61.9 MB of dout and the indices and writes
// the tables: about 70 MB each, 21 us at 3.35 TB/s.
//
// K4. One block per (bk, 256 queries) stores its whole output span, which
// is contiguous, with 16-byte streaming stores (__stcs: the output does not
// fit L2 and is read by the next kernel from HBM anyway): each thread
// builds a float4 from four table values read through the read-only cache
// (all 64 tables, 4.6 MB, sit in L2). The span's ends that are not 16-byte
// aligned are stored a float at a time. D is a template parameter, 35 for
// the path and 0 (read at run time) for any other D, so that the element ->
// (query, channel) split is a multiply, not a division. The first design
// stored 4 bytes an element after a runtime division, with one load
// in flight a thread, and was 1.4-1.5x slower than torch.gather. A copy, so
// the output is bit-identical to torch.gather. An index outside [0, T)
// gives a row of NaN (torch.gather would raise; checking would cost the
// wrapper a host synchronisation).
//
// K5, deterministic, with no atomics in global memory, one launch. Each
// block owns one keypoint's table rows (all of them where they fit in
// shared memory, as at the path's T = 512) for a group of DC channels, and
// keeps their sums in shared memory, one warp per channel. It streams the
// keypoint's dout columns and indices in ascending q through a ring of two
// 512-query tiles in shared memory, filled by cp.async so that one tile's
// copies are in flight while the warps add the other: lane l of a
// channel's warp adds query 32 j + l of chunk j to its row's sum. The rows
// of a chunk are one candidate's 32 neighbours, distinct on the path;
// where a chunk repeats a row, __match_any_sync ranks those lanes and they
// add one after another in lane order. So every (row, channel) sums its
// queries in ascending q, starting from 0, with __fadd_rn, as
// ops/kernels/onehot_gather.py's plain version adds: the same bits, run
// after run. An index outside [0, T) adds to no row. dout is read once, in
// order. The channel groups are the fewest that give every SM a block (3
// groups of 12 at the path's 64 keypoints x 35: 192 blocks of 92 KB, two
// an SM, one wave); a deeper ring fits one block an SM and takes two
// waves, which was slower. The first design sorted the keypoint's
// indices in each of 8 blocks of 64 rows, then summed each row's dout
// entries in random order, and the block holding the keypoint's nearest
// rows (72% of its queries: level 1 orders a table nearest first) carried
// most of the work; it was 2.2x slower than torch.scatter_add. Sorting
// once into row lists and summing a row per warp still read dout in random
// 140-byte pieces, and that sum alone was slower than torch.scatter_add.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr unsigned FULL = 0xffffffffu;

constexpr int GATHER_THREADS = 256;
constexpr int GATHER_QUERIES = 256;  // K4: queries per block

constexpr int SCATTER_TILE = 512;    // K5: queries a block stages per step
constexpr int SCATTER_STAGES = 2;    // tiles in the ring: one in flight while one is added
constexpr int SCATTER_CHUNKS = SCATTER_TILE / 32;
constexpr int SCATTER_LOADS = SCATTER_TILE / 32;  // dout values a thread copies per tile
constexpr int SCATTER_SMEM = 200 * 1024;          // of the 227 KB a block may use
constexpr int SCATTER_CHANNELS = 16;              // at most, a warp each

__device__ __forceinline__ float table_value(const float* btab, const int* s_idx, int p, int D) {
  const int r = p / D;
  const int t = s_idx[r];
  return t >= 0 ? __ldg(btab + t * D + (p - r * D)) : CUDART_NAN_F;
}

// DC > 0: D == DC known at compile time; DC == 0: D as given
template <int DC>
__global__ void __launch_bounds__(GATHER_THREADS)
onehot_gather_kernel(const float* __restrict__ table, const long long* __restrict__ idx,
                     float* __restrict__ out, int T, int Q, int d) {
  const int D = DC > 0 ? DC : d;
  __shared__ int s_idx[GATHER_QUERIES];
  const size_t bk = blockIdx.x;
  const int q0 = blockIdx.y * GATHER_QUERIES;
  const int rows = min(GATHER_QUERIES, Q - q0);
  const long long* bidx = idx + bk * Q + q0;
  for (int i = threadIdx.x; i < rows; i += GATHER_THREADS) {
    const long long t = bidx[i];
    s_idx[i] = (t >= 0 && t < T) ? static_cast<int>(t) : -1;
  }
  __syncthreads();
  const float* btab = table + bk * T * D;
  const size_t s = (bk * Q + q0) * D;  // the span out[s, s + n)
  float* bout = out + s;
  const int n = rows * D;
  // out is 16-byte aligned (the wrapper allocates it): the span's first
  // `head` floats lie before a 16-byte boundary
  const int head = min(n, static_cast<int>((4 - (s & 3)) & 3));
  const int nv = (n - head) / 4;
#pragma unroll 2
  for (int i = threadIdx.x; i < nv; i += GATHER_THREADS) {
    const int p = head + 4 * i;
    const float4 v = make_float4(
        table_value(btab, s_idx, p, D), table_value(btab, s_idx, p + 1, D),
        table_value(btab, s_idx, p + 2, D), table_value(btab, s_idx, p + 3, D));
    __stcs(reinterpret_cast<float4*>(bout + p), v);
  }
  const int tail = head + 4 * nv;
  for (int i = threadIdx.x; i < head + (n - tail); i += GATHER_THREADS) {
    const int p = i < head ? i : tail + (i - head);
    bout[p] = table_value(btab, s_idx, p, D);
  }
}

__device__ __forceinline__ void cp_async(void* dst, const void* src, int bytes) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  if (bytes == 8) {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 8;\n" ::"r"(d), "l"(src));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src));
  }
}

// Copy tile `tile` of the block's dout columns and of the indices into
// ring stage tile % SCATTER_STAGES, asynchronously: element (query ql +
// 32 k, channel ct) for each k, and indices threadIdx.x + k * nthreads.
__device__ __forceinline__ void stage_tile(int tile, float* s_tile, long long* s_idx,
                                           const float* bd, const long long* bidx, int Q,
                                           int D, int DCP, int dc, int nthreads, int ql,
                                           int ct) {
  const int stage = tile % SCATTER_STAGES;
  const int q0 = tile * SCATTER_TILE;
  float* st = s_tile + stage * SCATTER_TILE * DCP;
  if (ct < dc) {
#pragma unroll
    for (int k = 0; k < SCATTER_LOADS; ++k) {
      const int q = q0 + ql + 32 * k;
      if (q < Q) cp_async(st + (ql + 32 * k) * DCP + ct, bd + static_cast<size_t>(q) * D + ct, 4);
    }
  }
  for (int e = threadIdx.x; e < SCATTER_TILE && q0 + e < Q; e += nthreads) {
    cp_async(s_idx + stage * SCATTER_TILE + e, bidx + q0 + e, 8);
  }
}

// grid (BK, channel groups, row groups), 32 * DC threads: warp w sums
// channel c0 + w of rows [t0, t0 + TR) in shared memory
__global__ void __launch_bounds__(32 * SCATTER_CHANNELS)
onehot_scatter_add_kernel(const float* __restrict__ dout, const long long* __restrict__ idx,
                          float* __restrict__ dtable, int T, int Q, int D, int DC, int TR) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int DCP = DC | 1;  // an odd row stride: a warp's column reads hit 32 banks
  const int nthreads = 32 * DC;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const size_t bk = blockIdx.x;
  const int c0 = blockIdx.y * DC;
  const int dc = min(DC, D - c0);
  const int t0 = blockIdx.z * TR;
  const int tr = min(TR, T - t0);
  long long* s_idx = reinterpret_cast<long long*>(smem);     // [STAGES][TILE] indices
  float* s_tile = reinterpret_cast<float*>(s_idx + SCATTER_STAGES * SCATTER_TILE);
  float* s_acc = s_tile + SCATTER_STAGES * SCATTER_TILE * DCP;  // [TR][DCP] row sums
  int* s_row = reinterpret_cast<int*>(s_acc + TR * DCP);  // [TILE] row - t0, or -1
  int* s_rank = s_row + SCATTER_TILE;     // [TILE] rank among the chunk's lanes of that row
  int* s_rounds = s_rank + SCATTER_TILE;  // [CHUNKS] 1 + the chunk's largest rank
  const float* bd = dout + bk * Q * D + c0;
  const long long* bidx = idx + bk * Q;
  // this thread copies query ql + 32 k, channel ct of each tile
  const int ql = threadIdx.x / DC;
  const int ct = threadIdx.x - ql * DC;

  for (int i = threadIdx.x; i < tr * DCP; i += nthreads) s_acc[i] = 0.f;

  // a ring of SCATTER_STAGES tiles: STAGES - 1 in flight while one is added
  const int ntiles = (Q + SCATTER_TILE - 1) / SCATTER_TILE;
  for (int tile = 0; tile < SCATTER_STAGES - 1; ++tile) {
    if (tile < ntiles) stage_tile(tile, s_tile, s_idx, bd, bidx, Q, D, DCP, dc, nthreads, ql, ct);
    asm volatile("cp.async.commit_group;\n" ::);
  }
  for (int tile = 0; tile < ntiles; ++tile) {
    __syncthreads();  // the last tile's adds are done: its stage and s_row are free
    const int ahead = tile + SCATTER_STAGES - 1;
    if (ahead < ntiles) stage_tile(ahead, s_tile, s_idx, bd, bidx, Q, D, DCP, dc, nthreads, ql, ct);
    asm volatile("cp.async.commit_group;\n" ::);
    asm volatile("cp.async.wait_group %0;\n" ::"n"(SCATTER_STAGES - 1));
    __syncthreads();  // every thread's copies of this tile have landed

    const int stage = tile % SCATTER_STAGES;
    const int n = min(SCATTER_TILE, Q - tile * SCATTER_TILE);
    for (int ch = warp; ch * 32 < n; ch += DC) {
      const int j = ch * 32 + lane;
      const long long t = j < n ? s_idx[stage * SCATTER_TILE + j] : -1;
      const int r = (t >= t0 && t < t0 + tr) ? static_cast<int>(t - t0) : -1;
      const unsigned group = __match_any_sync(FULL, r);
      const int rank = __popc(group & ((1u << lane) - 1u));
      const int most = __reduce_max_sync(FULL, r >= 0 ? rank : 0);
      s_row[j] = r;
      s_rank[j] = rank;
      if (lane == 0) s_rounds[ch] = most + 1;
    }
    __syncthreads();

    if (warp < dc) {
      // chunk ch's row, value and rounds are read while chunk ch - 1 adds
      const float* st = s_tile + stage * SCATTER_TILE * DCP + warp;
      int r = s_row[lane];
      float v = st[lane * DCP];
      int rounds = s_rounds[0];
      for (int ch = 0; ch * 32 < n; ++ch) {
        const int j = ch * 32 + lane;
        const bool more = (ch + 1) * 32 < n;
        const int r_next = more ? s_row[j + 32] : -1;
        const float v_next = more ? st[(j + 32) * DCP] : 0.f;
        const int rounds_next = more ? s_rounds[ch + 1] : 1;
        if (rounds == 1) {
          if (r >= 0) s_acc[r * DCP + warp] = __fadd_rn(s_acc[r * DCP + warp], v);
        } else {  // a repeated row: its lanes add in lane order, so in ascending q
          const int rank = s_rank[j];
          for (int k = 0; k < rounds; ++k) {
            if (r >= 0 && rank == k) s_acc[r * DCP + warp] = __fadd_rn(s_acc[r * DCP + warp], v);
            __syncwarp();
          }
        }
        __syncwarp();  // this chunk's sums are seen by the next chunk's lanes
        r = r_next;
        v = v_next;
        rounds = rounds_next;
      }
    }
  }
  __syncthreads();
  float* bt = dtable + (bk * T + t0) * D + c0;
  for (int e = threadIdx.x; e < tr * dc; e += nthreads) {
    const int t = e / dc;
    const int c = e - t * dc;
    bt[static_cast<size_t>(t) * D + c] = s_acc[t * DCP + c];
  }
}

}  // namespace

// Plain C entry points for ctypes. table/dtable [BK, T, D], idx [BK, Q]
// int64, out/dout [BK, Q, D], all contiguous on the current device,
// float32 unless said otherwise, out 16-byte aligned; BK, T, Q, D >= 1,
// Q <= 65535 * 256. Each returns the cudaError_t of its launch (0 on
// success).
extern "C" int onehot_gather_f32(const float* table, const long long* idx, float* out, int BK,
                                 int T, int Q, int D, void* stream) {
  if (BK <= 0 || T <= 0 || Q <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(BK, (Q + GATHER_QUERIES - 1) / GATHER_QUERIES);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 35) {
    onehot_gather_kernel<35><<<grid, GATHER_THREADS, 0, s>>>(table, idx, out, T, Q, D);
  } else {
    onehot_gather_kernel<0><<<grid, GATHER_THREADS, 0, s>>>(table, idx, out, T, Q, D);
  }
  return static_cast<int>(cudaGetLastError());
}

// K5: dtable from dout and idx
extern "C" int onehot_scatter_add_f32(const float* dout, const long long* idx, float* dtable,
                                      int BK, int T, int Q, int D, void* stream) {
  if (BK <= 0 || T <= 0 || Q <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  // the card's SM count, and the kernel's shared-memory limit raised to
  // SCATTER_SMEM (every launch's need, below), once a card: the launch's
  // host time is the path's
  constexpr int MAX_DEVICES = 64;
  static int sms_of[MAX_DEVICES];
  static bool smem_raised[MAX_DEVICES];
  int device = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (device >= MAX_DEVICES) return static_cast<int>(cudaErrorInvalidDevice);
  int sms = sms_of[device];
  if (sms == 0) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return static_cast<int>(err);
    sms_of[device] = sms;
  }
  if (!smem_raised[device]) {
    err = cudaFuncSetAttribute(onehot_scatter_add_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, SCATTER_SMEM);
    if (err != cudaSuccess) return static_cast<int>(err);
    smem_raised[device] = true;
  }
  // channel groups: the fewest that give a block an SM, at most
  // SCATTER_CHANNELS channels (warps) a block, evened out
  int DC = D < SCATTER_CHANNELS ? D : SCATTER_CHANNELS;
  while (DC > 1 && static_cast<long long>(BK) * ((D + DC - 1) / DC) < sms) --DC;
  int groups = (D + DC - 1) / DC;
  DC = (D + groups - 1) / groups;
  groups = (D + DC - 1) / DC;
  // row groups: as many rows' sums as fit beside a tile
  const int DCP = DC | 1;
  const int fixed = SCATTER_STAGES * SCATTER_TILE * (8 + 4 * DCP)
                    + (2 * SCATTER_TILE + SCATTER_CHUNKS) * 4;
  const int fit = (SCATTER_SMEM - fixed) / (4 * DCP);
  const int row_groups = (T + fit - 1) / fit;
  const int TR = (T + row_groups - 1) / row_groups;
  if (row_groups > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = fixed + TR * DCP * 4;  // <= SCATTER_SMEM, since TR <= fit
  const dim3 grid(BK, groups, row_groups);
  onehot_scatter_add_kernel<<<grid, 32 * DC, smem, static_cast<cudaStream_t>(stream)>>>(
      dout, idx, dtable, T, Q, D, DC, TR);
  return static_cast<int>(cudaGetLastError());
}
