// Farthest-point sampling of a point cloud: kernel K3 of the port.
//
//   far = start; dist[n] = +inf
//   for i in 0 .. npoint-1:
//     out[i] = far
//     dist[n] = min(dist[n], |x_n - x_far|^2)
//     far = the FIRST n attaining max(dist)
//
// Replaces the TPU kernel deepvcp_tpu/ops/pallas/fps_kernel.py
// ::farthest_point_sample_pallas (_fps_kernel). It ports what that kernel
// computes, not Mosaic's layout: there is no [8, Npad] padding, no one-hot
// merge of the output and no masked-sum read of the centroid.
//
// Design. One thread-block cluster per cloud: CS blocks (a power of two up
// to 16, chosen by the wrapper from N; 16 needs the non-portable cluster
// size) split the cloud into CS contiguous shares. A block of 256 threads
// keeps its share's coordinates and running distances in registers, PPT
// points a thread (a template parameter); a share above 16 points a thread
// streams through global scratch instead (the STREAM instantiation), so any
// N runs. A pick:
//   1. each thread updates its distances and keeps its (max, first index);
//   2. a warp reduces (monotone 32-bit key of the distance, index) with
//      __reduce_max_sync on the key, then __reduce_min_sync on the index
//      among the lanes at the max;
//   3. CS lanes of each warp send the warp's record into its slot in every
//      block of the cluster by st.async, which counts the bytes on the
//      receiving block's mbarrier; slots are double-buffered by pick parity;
//   4. each block waits on its own mbarrier for its CS x 8 records only
//      (no cluster-wide barrier: a one-way trip, not a round trip);
//   5. every warp reduces its block's records, so every thread of the
//      cluster knows the next centroid. Thread 0 re-arms the buffer's
//      barrier for pick i + 2; no record of pick i + 2 can arrive before
//      every block has read pick i's, since it needs their records of pick
//      i + 1, sent after that read.
// A record is (key, index), 8 bytes, and the centroid's xyz comes from the
// block's copy of the cloud in shared memory (N <= 12 800, 16 bytes a
// point); a larger cloud sends 24-byte records that carry the xyz.
// Measured against it (PERF.md §6): a cluster barrier per pick, about
// twice as slow; tagged records polled in place with relaxed loads, 1.6x;
// one record a block after a __syncthreads, spinning on test_wait and 512
// threads a block, no faster.
//
// What bounds it. Not bytes (the cloud is read once) nor arithmetic (~10
// flops per point and pick): npoint dependent picks, each a pass over a
// block's registers, two warp reductions, the records' trip to every block
// and their reduction. That protocol alone sets a floor per pick, lowest on
// one block and rising with the cluster (more records), while the distance
// pass falls with it. chip_smoke.py times the protocol alone with
// fps_pick_probe at cluster sizes 1-16.
//
// Exactness. d = ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest
// intrinsics (nvcc would otherwise contract it into FMAs, which round
// differently and can flip a near-tie), the expression the plain PyTorch
// version evaluates, so the distances are bit-identical. The winner rule
// (larger distance, then lower index) is associative and commutative, so
// the winner is the first maximum in index order whatever the split, as
// jnp.argmax and torch.argmax pick. A non-negative float's bits order as
// the float does; key = bits + 1 leaves 0 for "no point".

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstddef>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int MAX_CLUSTER = 16;
constexpr int SLOTS = MAX_CLUSTER * WARPS;
constexpr int REG_PPT = 16;         // points a thread holds in registers, at most
constexpr int SHORT_MAX_N = 12800;  // clouds a block copies: 16 bytes a point
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// The address of the same shared variable in block `rank` of the cluster.
__device__ __forceinline__ unsigned remote(unsigned addr, unsigned rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n" : "=r"(r) : "r"(addr), "r"(rank));
  return r;
}

__device__ __forceinline__ void st_async4(unsigned addr, uint4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 [%0], {%1, %2, %3, %4}, [%5];\n"
      ::"r"(addr), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w), "r"(bar) : "memory");
}

__device__ __forceinline__ void st_async2(unsigned addr, uint2 v, unsigned bar) {
  asm volatile("st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 [%0], {%1, %2}, [%3];\n"
               ::"r"(addr), "r"(v.x), "r"(v.y), "r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_init(unsigned bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ void mbar_expect(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.release.cta.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n"
        ".reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n"
        "}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

__device__ __forceinline__ float sq_dist(float ax, float ay, float az, float bx, float by,
                                         float bz) {
  const float dx = __fsub_rn(ax, bx);
  const float dy = __fsub_rn(ay, by);
  const float dz = __fsub_rn(az, bz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)), __fmul_rn(dz, dz));
}

// The slot of the best record of rec[0 .. n) under the winner rule (larger
// key .x, then lower index .y), read by a warp; every lane returns it.
template <typename T>
__device__ __forceinline__ int scan_best(const T* rec, int n) {
  const int lane = threadIdx.x & 31;
  unsigned bk = 0, bi = FULL;
  int bs = 0;
  for (int sl = lane; sl < n; sl += 32) {
    const T e = rec[sl];
    if (e.x > bk || (e.x == bk && e.y < bi)) {
      bk = e.x;
      bi = e.y;
      bs = sl;
    }
  }
  const unsigned gk = __reduce_max_sync(FULL, bk);
  const unsigned gi = __reduce_min_sync(FULL, bk == gk ? bi : FULL);
  return __shfl_sync(FULL, bs, __ffs(__ballot_sync(FULL, bk == gk && bi == gi)) - 1);
}

// Shared state of one block: slot (rank, warp) of buffer p holds that
// warp's record, (key, index) in key2 for SHORT records, or (key, index,
// x, y) in key4 and (z, 0) in key2; bar[p] counts buffer p's bytes.
struct Slots {
  uint4 key4[2][SLOTS];
  uint2 key2[2][SLOTS];
  unsigned long long bar[2];
};

template <bool SHORT>
__device__ __forceinline__ unsigned pick_bytes(int cs) {
  return cs * WARPS * (SHORT ? 8u : 24u);
}

// Thread 0 sets up both buffers' barriers and arms them for picks 1 and 2
// (buffer i & 1 serves pick i); the caller then syncs the cluster, so no
// record flies before every block's barriers are armed.
template <bool SHORT>
__device__ __forceinline__ void init_bars(Slots& s, int cs, int npoint) {
  if (threadIdx.x == 0) {
    mbar_init(smem_addr(&s.bar[0]));
    mbar_init(smem_addr(&s.bar[1]));
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    if (npoint > 1) mbar_expect(smem_addr(&s.bar[1]), pick_bytes<SHORT>(cs));
    if (npoint > 2) mbar_expect(smem_addr(&s.bar[0]), pick_bytes<SHORT>(cs));
  }
}

// Steps 2-5 of pick i (>= 1) for a thread whose best is (bd, bn) at (bx,
// by, bz); bd < 0 means it holds no point. `dst` is the shared::cluster
// address of the Slots of the block this lane writes to. Returns the next
// centroid's index and sets its xyz (from `cloud` for SHORT records).
template <bool SHORT>
__device__ __forceinline__ int cluster_best(Slots& s, unsigned dst, const float4* cloud, int i,
                                            int npoint, int rank, int cs, float bd, int bn,
                                            float bx, float by, float bz, float& cx, float& cy,
                                            float& cz) {
  const int lane = threadIdx.x & 31;
  const int p = i & 1;
  const unsigned key = bd >= 0.f ? __float_as_uint(bd) + 1u : 0u;
  const unsigned wkey = __reduce_max_sync(FULL, key);
  const unsigned widx = __reduce_min_sync(FULL, key == wkey ? static_cast<unsigned>(bn) : FULL);
  const unsigned slot = p * SLOTS + rank * WARPS + (threadIdx.x >> 5);
  const unsigned at2 = dst + offsetof(Slots, key2) + slot * sizeof(uint2);
  const unsigned bar = dst + offsetof(Slots, bar) + p * sizeof(unsigned long long);
  if constexpr (SHORT) {
    if (lane < cs) st_async2(at2, make_uint2(wkey, widx), bar);  // lane l to block l
  } else {
    const int wl = __ffs(__ballot_sync(FULL, key == wkey && static_cast<unsigned>(bn) == widx)) - 1;
    const uint4 v = make_uint4(wkey, widx, __float_as_uint(__shfl_sync(FULL, bx, wl)),
                               __float_as_uint(__shfl_sync(FULL, by, wl)));
    const uint2 vz = make_uint2(__float_as_uint(__shfl_sync(FULL, bz, wl)), 0u);
    if (lane < cs) {
      st_async4(dst + offsetof(Slots, key4) + slot * sizeof(uint4), v, bar);
      st_async2(at2, vz, bar);
    }
  }
  const unsigned own = smem_addr(&s.bar[p]);
  mbar_wait(own, ((i - 1) >> 1) & 1);
  if (threadIdx.x == 0 && i + 2 < npoint) mbar_expect(own, pick_bytes<SHORT>(cs));
  if constexpr (SHORT) {
    const int far = static_cast<int>(s.key2[p][scan_best(s.key2[p], cs * WARPS)].y);
    const float4 c = cloud[far];
    cx = c.x;
    cy = c.y;
    cz = c.z;
    return far;
  } else {
    const int ws = scan_best(s.key4[p], cs * WARPS);
    const uint4 e = s.key4[p][ws];
    cx = __uint_as_float(e.z);
    cy = __uint_as_float(e.w);
    cz = __uint_as_float(s.key2[p][ws].x);
    return static_cast<int>(e.y);
  }
}

template <int PPT, bool STREAM, bool SHORT>
__global__ void __launch_bounds__(THREADS)
fps_kernel(const float* __restrict__ xyz, float* __restrict__ scratch,
           long long* __restrict__ out, int N, int npoint, int start, int share) {
  __shared__ Slots s;
  extern __shared__ float4 cloud[];  // SHORT: the whole cloud's xyz
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int cloud_id = blockIdx.x / cs;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const float* bx = xyz + static_cast<size_t>(cloud_id) * N * 3;
  long long* bo = out + static_cast<size_t>(cloud_id) * npoint;
  const int n0 = min(rank * share, N);
  const int n1 = min(n0 + share, N);
  // this thread's points: n0 + tid + j * THREADS < n1, a prefix of j
  const int mine = n1 - n0 > tid ? (n1 - n0 - tid - 1) / THREADS + 1 : 0;

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
  if constexpr (!STREAM) {
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const int n = n0 + tid + j * THREADS;
      const bool live = j < mine;
      px[j] = live ? bx[3 * n] : 0.f;
      py[j] = live ? bx[3 * n + 1] : 0.f;
      pz[j] = live ? bx[3 * n + 2] : 0.f;
      dist[j] = CUDART_INF_F;
    }
  }
  if constexpr (SHORT) {
    for (int n = tid; n < N; n += THREADS) {
      cloud[n] = make_float4(bx[3 * n], bx[3 * n + 1], bx[3 * n + 2], 0.f);
    }
  }
  const unsigned dst = remote(smem_addr(&s), lane < cs ? lane : 0);
  init_bars<SHORT>(s, cs, npoint);
  cluster.sync();

  int far = start;
  float cx = bx[3 * far], cy = bx[3 * far + 1], cz = bx[3 * far + 2];
  if (rank == 0 && tid == 0) bo[0] = far;
  for (int i = 1; i < npoint; ++i) {
    float bd = -1.f, bxx = 0.f, byy = 0.f, bzz = 0.f;
    int bn = 0;
    if constexpr (STREAM) {
      float* sd = scratch + static_cast<size_t>(cloud_id) * N;
      for (int n = n0 + tid; n < n1; n += THREADS) {
        const float x = bx[3 * n], y = bx[3 * n + 1], z = bx[3 * n + 2];
        const float old = i == 1 ? CUDART_INF_F : sd[n];
        const float d = fminf(old, sq_dist(x, y, z, cx, cy, cz));
        sd[n] = d;
        if (d > bd) {  // strict: n ascends, the first max stays
          bd = d;
          bn = n;
          bxx = x;
          byy = y;
          bzz = z;
        }
      }
    } else {
#pragma unroll
      for (int j = 0; j < PPT; ++j) {
        if (j < mine) {
          dist[j] = fminf(dist[j], sq_dist(px[j], py[j], pz[j], cx, cy, cz));
          if (dist[j] > bd) {  // strict: n ascends with j, the first max stays
            bd = dist[j];
            bn = n0 + tid + j * THREADS;
            bxx = px[j];
            byy = py[j];
            bzz = pz[j];
          }
        }
      }
    }
    far = cluster_best<SHORT>(s, dst, cloud, i, npoint, rank, cs, bd, bn, bxx, byy, bzz, cx, cy,
                              cz);
    if (rank == 0 && tid == 0) bo[i] = far;
  }
}

// The pick protocol alone (steps 2-5 with 8-byte records, on made-up
// keys), `iters` times: its time per iteration is the floor of a pick at
// this cluster size. BARRIER: the same records by plain remote stores and
// one cluster barrier a pick (arrive.release, wait.acquire) in place of
// st.async and the mbarrier, the barrier + round trip the design avoids.
template <bool BARRIER>
__global__ void __launch_bounds__(THREADS) fps_probe_kernel(int iters, int* smid) {
  __shared__ Slots s;
  __shared__ float4 cloud[THREADS];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  cloud[tid] = make_float4(0.f, 0.f, 0.f, 0.f);
  const unsigned dst = remote(smem_addr(&s), lane < cs ? lane : 0);
  if constexpr (!BARRIER) init_bars<true>(s, cs, iters + 1);
  cluster.sync();
  int far = 0;
  float cx = 0.f, cy = 0.f, cz = 0.f;
  for (int i = 1; i <= iters; ++i) {
    const unsigned n = rank * THREADS + tid;
    const float bd = static_cast<float>((n * 2654435761u + static_cast<unsigned>(far)) >> 8);
    // indices repeat across blocks here (ties are broken all the same)
    if constexpr (BARRIER) {
      const int p = i & 1;
      const unsigned key = __float_as_uint(bd) + 1u;
      const unsigned wkey = __reduce_max_sync(FULL, key);
      const unsigned widx = __reduce_min_sync(FULL, key == wkey ? static_cast<unsigned>(tid) : FULL);
      if (lane < cs) {
        cluster.map_shared_rank(&s.key2[0][0], lane)[p * SLOTS + rank * WARPS + (tid >> 5)] =
            make_uint2(wkey, widx);
      }
      asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
      asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
      far = static_cast<int>(s.key2[p][scan_best(s.key2[p], cs * WARPS)].y);
      cz = cloud[far].z;
    } else {
      far = cluster_best<true>(s, dst, cloud, i, iters + 1, rank, cs, bd, tid, cx, cy, cz, cx, cy,
                               cz);
    }
  }
  if (tid == 0) {
    unsigned id;
    asm volatile("mov.u32 %0, %%smid;" : "=r"(id));
    smid[blockIdx.x] = far >= 0 && cz == 0.f ? static_cast<int>(id) : -1;
  }
}

template <typename Kernel, typename... Args>
int launch_cluster(Kernel kernel, int blocks, int cs, int smem, cudaStream_t stream,
                   Args... args) {
  // cluster sizes above 8 are non-portable and must be allowed per kernel
  cudaError_t err = cudaFuncSetAttribute(kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (err == cudaSuccess && smem > 0) {  // static + dynamic may pass 48 KB: opt in
    err = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(blocks);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kernel, args...);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int PPT, bool STREAM>
int launch(const float* xyz, float* scratch, long long* out, int B, int N, int npoint,
           int start, int cs, int share, cudaStream_t s) {
  if (N <= SHORT_MAX_N) {
    return launch_cluster(fps_kernel<PPT, STREAM, true>, B * cs, cs, 16 * N, s, xyz, scratch, out,
                          N, npoint, start, share);
  }
  return launch_cluster(fps_kernel<PPT, STREAM, false>, B * cs, cs, 0, s, xyz, scratch, out, N,
                        npoint, start, share);
}

bool valid_cluster(int cs) { return cs >= 1 && cs <= MAX_CLUSTER && (cs & (cs - 1)) == 0; }

}  // namespace

// Plain C entry point for ctypes. xyz [B, N, 3] contiguous float32, out
// [B, npoint] int64, on the current device; 0 <= start < N; `cluster` blocks
// per cloud (a power of two up to 16). Each block takes ceil(N / cluster)
// points; above 16 a thread they stream through `scratch` ([B, N] float32,
// else unused and may be null). Returns the cudaError_t of the launch (0 on
// success).
extern "C" int fps_f32(const float* xyz, long long* out, float* scratch, int B, int N,
                       int npoint, int start, int cluster, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || start < 0 || start >= N || !valid_cluster(cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int share = (N + cluster - 1) / cluster;
  const int ppt = (share + THREADS - 1) / THREADS;
#define FPS_LAUNCH(P, STREAM) \
  return launch<P, STREAM>(xyz, scratch, out, B, N, npoint, start, cluster, share, s)
  if (ppt <= 1) FPS_LAUNCH(1, false);
  if (ppt <= 2) FPS_LAUNCH(2, false);
  if (ppt <= 3) FPS_LAUNCH(3, false);
  if (ppt <= 4) FPS_LAUNCH(4, false);
  if (ppt <= 5) FPS_LAUNCH(5, false);
  if (ppt <= 6) FPS_LAUNCH(6, false);
  if (ppt <= 8) FPS_LAUNCH(8, false);
  if (ppt <= 10) FPS_LAUNCH(10, false);
  if (ppt <= 12) FPS_LAUNCH(12, false);
  if (ppt <= REG_PPT) FPS_LAUNCH(REG_PPT, false);
  if (scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  FPS_LAUNCH(1, true);
#undef FPS_LAUNCH
}

// The pick protocol alone: B clusters of `cluster` blocks run `iters`
// picks, by the kernel's st.async protocol or (`barrier`) a cluster barrier
// a pick; smid[B * cluster] receives each block's SM. Returns the
// cudaError_t of the launch.
extern "C" int fps_pick_probe(int B, int cluster, int iters, int barrier, int* smid,
                              void* stream) {
  if (B <= 0 || iters <= 0 || !valid_cluster(cluster)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (barrier) return launch_cluster(fps_probe_kernel<true>, B * cluster, cluster, 0, s, iters, smid);
  return launch_cluster(fps_probe_kernel<false>, B * cluster, cluster, 0, s, iters, smid);
}
