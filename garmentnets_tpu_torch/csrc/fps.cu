// Furthest point sampling on Hopper: one barrier per pick.
//
// Replaces the TPU kernel garmentnets_tpu/kernels/fps_pallas.py:65
// (furthest_point_sampling_pallas / _fps_kernel).
//
// Computes, for each batch row, M sequential picks over N points:
//   mind = min(mind, |p - p_last|^2);  next = argmax(mind)
// starting at index 0 with mind = +inf, the lowest index winning ties. The
// indices equal the plain PyTorch version's exactly: the squared distance is
// formed as ((dx*dx + dy*dy) + dz*dz) with explicitly rounded operations
// (__fmul_rn/__fadd_rn/__fsub_rn), so nvcc cannot contract it into FMAs and
// shift near-ties.
//
// What bounds it: the M-1 picks are a chain of dependent steps, each a
// block-wide argmax, so the time is the latency of one pick times M-1. The
// byte and operation bounds (a few tens of microseconds per batch) say
// nothing about that chain. At N = 6000 a pick is ~6000 x 12 instructions of
// arithmetic spread over the 128 lanes of one SM (~0.3 us), plus the
// latency of the reduction and of one barrier.
//
// What the design does about it (one block per batch row; B = 8 rows run
// side by side on 8 SMs):
// - The running minimum and the coordinates live in registers: a thread of
//   the register instance (512 threads, PPT points each, PPT in
//   {2, 4, 6, 8, 12, 16}, chosen by the wrapper) holds points t + i * 512,
//   so a pick reads no shared memory except the winner's coordinates. The
//   shared copy of the positions serves only that read.
// - The argmax of a warp is two `redux` instructions instead of ten pairs of
//   shuffles: a distance is >= 0, so its f32 bits order like an unsigned
//   int; __reduce_max_sync on the bits gives the warp's maximum and
//   __reduce_min_sync on (bits == max ? index : UINT_MAX) the lowest index
//   that holds it. Within a thread the points are visited in rising index
//   and only a strictly larger distance replaces the best, so the first
//   occurrence is kept.
// - One __syncthreads per pick: lane 0 of each warp writes its (bits,
//   index) into a [2][warps] array indexed by the pick's parity, and after
//   the barrier every warp reduces the 16 (or 32) partials itself with the
//   same two instructions, so no second barrier and no broadcast of the
//   winner are needed. The parity keeps a fast warp's next write from
//   landing on a partial that a slow warp has yet to read: the next write
//   to the same half comes after the next barrier.
// - Points past N in the register instance hold distance 0 (bits 0) and
//   indices >= N, so they never beat a real point: on a tie the lower,
//   real index wins.
// - N above 16 x 512 (up to MAX_POINTS = 14464 in kernels/fps.py) takes the
//   shared-memory instance: 1024 threads, positions and running minimum in
//   dynamic shared memory (16 bytes a point, 231 KB at MAX_POINTS), with the
//   same one-barrier reduction.
// The index of each pick goes to global memory from thread 0, a store that
// no later step waits on (a build that left those stores out took the
// same time).
//
// Where a pick's time goes (tools/profile_stage1.py sweeps N): a fixed
// part, the chain of redux, barrier, partials and the winner's
// coordinates, and a part that grows with the points a thread holds, ~12
// instructions a point issued by 4 warps on each of the SM's 4
// schedulers. Spreading a row over a cluster of 2 or 4 blocks (distributed
// shared memory, one cluster barrier a pick) was tried and was slower at
// N = 6000 and 3000: the cluster barrier costs more than the arithmetic it
// takes off each block.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kRegThreads = 512;
constexpr int kSmemThreads = 1024;
constexpr unsigned kFull = 0xffffffffu;
constexpr unsigned kNoIndex = 0xffffffffu;

__device__ __forceinline__ float sq_dist(float x, float y, float z, float cx,
                                         float cy, float cz) {
  const float dx = __fsub_rn(x, cx);
  const float dy = __fsub_rn(y, cy);
  const float dz = __fsub_rn(z, cz);
  return __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                   __fmul_rn(dz, dz));
}

// The block's (largest key, lowest index holding it) with one barrier.
// part_k / part_i: [2][kWarps] in shared memory; parity: the pick's parity.
template <int kWarps>
__device__ __forceinline__ unsigned block_argmax(unsigned key, unsigned index,
                                                 unsigned* part_k,
                                                 unsigned* part_i, int parity,
                                                 int lane, int warp) {
  const unsigned wk = __reduce_max_sync(kFull, key);
  const unsigned wi = __reduce_min_sync(kFull, key == wk ? index : kNoIndex);
  if (lane == 0) {
    part_k[parity * kWarps + warp] = wk;
    part_i[parity * kWarps + warp] = wi;
  }
  __syncthreads();
  const unsigned k = lane < kWarps ? part_k[parity * kWarps + lane] : 0u;
  const unsigned i = lane < kWarps ? part_i[parity * kWarps + lane] : kNoIndex;
  const unsigned bk = __reduce_max_sync(kFull, k);
  return __reduce_min_sync(kFull, k == bk ? i : kNoIndex);
}

template <int PPT>
__global__ void __launch_bounds__(kRegThreads, 1)
fps_reg_kernel(const float* __restrict__ pos, int n, int m,
               int64_t* __restrict__ out) {
  constexpr int kWarps = kRegThreads / 32;
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  __shared__ unsigned part_k[2 * kWarps], part_i[2 * kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* p = pos + static_cast<int64_t>(blockIdx.x) * n * 3;
  int64_t* o = out + static_cast<int64_t>(blockIdx.x) * m;
  float px[PPT], py[PPT], pz[PPT], mind[PPT];
#pragma unroll
  for (int i = 0; i < PPT; ++i) {
    const int j = t + i * kRegThreads;
    px[i] = py[i] = pz[i] = mind[i] = 0.0f;
    if (j < n) {
      px[i] = p[3 * j];
      py[i] = p[3 * j + 1];
      pz[i] = p[3 * j + 2];
      mind[i] = CUDART_INF_F;
      xs[j] = px[i];
      ys[j] = py[i];
      zs[j] = pz[i];
    }
  }
  if (t == 0) o[0] = 0;
  __syncthreads();

  unsigned last = 0;
  for (int step = 1; step < m; ++step) {
    const float cx = xs[last], cy = ys[last], cz = zs[last];
    unsigned best = 0, best_i = t;
#pragma unroll
    for (int i = 0; i < PPT; ++i) {
      const float md = fminf(mind[i], sq_dist(px[i], py[i], pz[i], cx, cy, cz));
      mind[i] = md;
      const unsigned key = __float_as_uint(md);
      if (key > best) {
        best = key;
        best_i = t + i * kRegThreads;
      }
    }
    last = block_argmax<kWarps>(best, best_i, part_k, part_i, step & 1, lane,
                                warp);
    if (t == 0) o[step] = last;
  }
}

__global__ void __launch_bounds__(kSmemThreads, 1)
fps_smem_kernel(const float* __restrict__ pos, int n, int m,
                int64_t* __restrict__ out) {
  constexpr int kWarps = kSmemThreads / 32;
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* mind = zs + n;
  __shared__ unsigned part_k[2 * kWarps], part_i[2 * kWarps];

  const int t = threadIdx.x;
  const int lane = t & 31;
  const int warp = t >> 5;
  const float* p = pos + static_cast<int64_t>(blockIdx.x) * n * 3;
  int64_t* o = out + static_cast<int64_t>(blockIdx.x) * m;
  for (int j = t; j < n; j += kSmemThreads) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
    mind[j] = CUDART_INF_F;
  }
  if (t == 0) o[0] = 0;
  __syncthreads();

  unsigned last = 0;
  for (int step = 1; step < m; ++step) {
    const float cx = xs[last], cy = ys[last], cz = zs[last];
    unsigned best = 0, best_i = t;
    for (int j = t; j < n; j += kSmemThreads) {
      const float md = fminf(mind[j], sq_dist(xs[j], ys[j], zs[j], cx, cy, cz));
      mind[j] = md;
      const unsigned key = __float_as_uint(md);
      if (key > best) {
        best = key;
        best_i = j;
      }
    }
    last = block_argmax<kWarps>(best, best_i, part_k, part_i, step & 1, lane,
                                warp);
    if (t == 0) o[step] = last;
  }
}

template <typename Kernel>
int launch(Kernel kern, int threads, size_t smem, const float* pos, int b,
           int n, int m, int64_t* out, void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  kern<<<b, threads, smem, static_cast<cudaStream_t>(stream)>>>(pos, n, m,
                                                                out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// ppt: points per thread of the register instance (n <= 512 * ppt), or 0
// for the shared-memory instance.
extern "C" int fps_launch(const float* pos, int b, int n, int m, int ppt,
                          int64_t* out, void* stream) {
  if (b < 1 || n < 1 || m < 1 || (ppt > 0 && n > kRegThreads * ppt))
    return static_cast<int>(cudaErrorInvalidValue);
  const size_t reg_smem = sizeof(float) * 3 * static_cast<size_t>(n);
  switch (ppt) {
#define FPS_REG(P) \
  case P:          \
    return launch(fps_reg_kernel<P>, kRegThreads, reg_smem, pos, b, n, m, \
                  out, stream);
    FPS_REG(2) FPS_REG(4) FPS_REG(6) FPS_REG(8) FPS_REG(12) FPS_REG(16)
#undef FPS_REG
    case 0:
      return launch(fps_smem_kernel, kSmemThreads,
                    sizeof(float) * 4 * static_cast<size_t>(n), pos, b, n, m,
                    out, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
