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
// Design. One block of 1024 threads per cloud. Thread t owns the points
// n = j * 1024 + t for j < PPT (a template parameter) and keeps their
// coordinates and running distances in registers for the whole loop. An
// iteration: each thread updates its distances and finds its local
// (max, first index) and that point's coordinates; a butterfly of
// __shfl_xor_sync gives every lane its warp's (max, index); the lane that
// owns the winner writes it and its coordinates to shared memory; one
// __syncthreads(); then every warp reduces the 32 warp winners itself, so
// all threads know the next centroid without a second barrier. The
// shared slots are double-buffered: a warp can overwrite a slot only after
// the next iteration's barrier, which every warp reaches after it has
// read the slot.
//
// What bounds it. Not bytes (the cloud is read once) nor arithmetic
// (~10 flops per point and iteration): npoint dependent iterations, each a
// pass over the block's registers, a warp butterfly, a block barrier and a
// second butterfly, on one SM per cloud. At B = 2 two of the card's 132
// SMs work. A thread-block cluster splitting one cloud over several SMs
// (distributed shared memory) is the way to more; not done here.
//
// Exactness. d = ((dx*dx) + (dy*dy)) + (dz*dz) in round-to-nearest
// intrinsics (nvcc would otherwise contract it into FMAs, which round
// differently and can flip a near-tie), the expression the plain PyTorch
// version evaluates, so the distances are bit-identical. The reduction
// order (larger distance wins, the lower index on equal distances) is
// associative and commutative, so the winner is the first maximum in index
// order whatever the tree, as jnp.argmax and torch.argmax pick.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <climits>

namespace {

constexpr int THREADS = 1024;
constexpr int WARPS = THREADS / 32;
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ bool beats(float d, int i, float od, int oi) {
  return d > od || (d == od && i < oi);
}

template <int PPT>
__global__ void __launch_bounds__(THREADS, 1)
fps_kernel(const float* __restrict__ xyz, long long* __restrict__ out, int N,
           int npoint, int start) {
  __shared__ float s_d[2][WARPS];
  __shared__ int s_i[2][WARPS];
  __shared__ float s_c[2][WARPS][3];

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const float* bx = xyz + static_cast<size_t>(blockIdx.x) * N * 3;
  long long* bo = out + static_cast<size_t>(blockIdx.x) * npoint;

  float px[PPT], py[PPT], pz[PPT], dist[PPT];
#pragma unroll
  for (int j = 0; j < PPT; ++j) {
    const int n = j * THREADS + tid;
    const bool live = n < N;
    px[j] = live ? bx[3 * n] : 0.f;
    py[j] = live ? bx[3 * n + 1] : 0.f;
    pz[j] = live ? bx[3 * n + 2] : 0.f;
    // a padding slot stays at -inf under min() and never wins
    dist[j] = live ? CUDART_INF_F : -CUDART_INF_F;
  }

  int far = start;
  float cx = bx[3 * far], cy = bx[3 * far + 1], cz = bx[3 * far + 2];
  for (int i = 0; i < npoint; ++i) {
    if (tid == 0) bo[i] = far;
    float bd = -CUDART_INF_F, bxx = 0.f, byy = 0.f, bzz = 0.f;
    int bi = INT_MAX;
#pragma unroll
    for (int j = 0; j < PPT; ++j) {
      const float dx = __fsub_rn(px[j], cx);
      const float dy = __fsub_rn(py[j], cy);
      const float dz = __fsub_rn(pz[j], cz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      dist[j] = fminf(dist[j], d);
      if (dist[j] > bd) {  // strict: indices ascend with j, the first max stays
        bd = dist[j];
        bi = j * THREADS + tid;
        bxx = px[j];
        byy = py[j];
        bzz = pz[j];
      }
    }
    const int mine = bi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, bd, off);
      const int oi = __shfl_xor_sync(FULL, bi, off);
      if (beats(od, oi, bd, bi)) {
        bd = od;
        bi = oi;
      }
    }
    const int p = i & 1;
    if (lane == 0) {
      s_d[p][warp] = bd;
      s_i[p][warp] = bi;
    }
    if (mine == bi && bi != INT_MAX) {  // the one lane that owns the winner
      s_c[p][warp][0] = bxx;
      s_c[p][warp][1] = byy;
      s_c[p][warp][2] = bzz;
    }
    __syncthreads();
    float wd = s_d[p][lane];
    int wi = s_i[p][lane];
    int ww = lane;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const float od = __shfl_xor_sync(FULL, wd, off);
      const int oi = __shfl_xor_sync(FULL, wi, off);
      const int ow = __shfl_xor_sync(FULL, ww, off);
      if (beats(od, oi, wd, wi)) {
        wd = od;
        wi = oi;
        ww = ow;
      }
    }
    far = wi;
    cx = s_c[p][ww][0];
    cy = s_c[p][ww][1];
    cz = s_c[p][ww][2];
  }
}

template <int PPT>
int launch(const float* xyz, long long* out, int B, int N, int npoint, int start,
           cudaStream_t stream) {
  fps_kernel<PPT><<<B, THREADS, 0, stream>>>(xyz, out, N, npoint, start);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry point for ctypes. xyz [B, N, 3] contiguous float32, out
// [B, npoint] int64, on the current device; 1 <= N <= 16 * 1024,
// 0 <= start < N. Returns the cudaError_t of the launch (0 on success).
extern "C" int fps_f32(const float* xyz, long long* out, int B, int N, int npoint,
                       int start, void* stream) {
  if (B <= 0 || N <= 0 || npoint <= 0 || start < 0 || start >= N) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int ppt = (N + THREADS - 1) / THREADS;
  if (ppt <= 1) return launch<1>(xyz, out, B, N, npoint, start, s);
  if (ppt <= 2) return launch<2>(xyz, out, B, N, npoint, start, s);
  if (ppt <= 4) return launch<4>(xyz, out, B, N, npoint, start, s);
  if (ppt <= 8) return launch<8>(xyz, out, B, N, npoint, start, s);
  if (ppt <= 10) return launch<10>(xyz, out, B, N, npoint, start, s);
  if (ppt <= 16) return launch<16>(xyz, out, B, N, npoint, start, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
