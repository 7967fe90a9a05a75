// Furthest point sampling on Hopper.
//
// Replaces the TPU kernel garmentnets_tpu/kernels/fps_pallas.py
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
// What bounds it: the M-1 picks are dependent steps, each a block-wide
// argmax, so the kernel is latency-bound (a few microseconds per step), far
// above both the byte and the operation bound. Its design keeps everything a
// step touches on chip: one block per batch row holds the positions
// (3 x N floats) and the running minimum (N floats) in dynamic shared
// memory (96 KB at N = 6000, above the 48 KB default, hence the
// MaxDynamicSharedMemorySize attribute), and each step costs one pass over
// shared memory plus two block barriers. B = 8 fills only 8 of 132 SMs;
// making it fast is later work.

#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;

// (value, index) pair order: larger value wins, lower index wins ties.
__device__ __forceinline__ void better(float& v, int& i, float ov, int oi) {
  if (ov > v || (ov == v && oi < i)) {
    v = ov;
    i = oi;
  }
}

__global__ void __launch_bounds__(kThreads)
fps_kernel(const float* __restrict__ pos, int n, int m,
           int64_t* __restrict__ out) {
  extern __shared__ float smem[];
  float* xs = smem;
  float* ys = xs + n;
  float* zs = ys + n;
  float* mind = zs + n;
  __shared__ float warp_v[kWarps];
  __shared__ int warp_i[kWarps];
  __shared__ int last_s;

  const int b = blockIdx.x;
  const float* p = pos + static_cast<int64_t>(b) * n * 3;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    xs[j] = p[3 * j];
    ys[j] = p[3 * j + 1];
    zs[j] = p[3 * j + 2];
    mind[j] = CUDART_INF_F;
  }
  if (threadIdx.x == 0) {
    out[static_cast<int64_t>(b) * m] = 0;
    last_s = 0;
  }
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  for (int step = 1; step < m; ++step) {
    const int last = last_s;
    const float px = xs[last], py = ys[last], pz = zs[last];
    float best = -1.0f;  // every distance is >= 0
    int best_i = n;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const float dx = __fsub_rn(xs[j], px);
      const float dy = __fsub_rn(ys[j], py);
      const float dz = __fsub_rn(zs[j], pz);
      const float d = __fadd_rn(__fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy)),
                                __fmul_rn(dz, dz));
      const float md = fminf(mind[j], d);
      mind[j] = md;
      if (md > best) {  // j rises within a thread: first occurrence kept
        best = md;
        best_i = j;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const float ov = __shfl_down_sync(0xffffffffu, best, off);
      const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
      better(best, best_i, ov, oi);
    }
    if (lane == 0) {
      warp_v[warp] = best;
      warp_i[warp] = best_i;
    }
    __syncthreads();
    if (warp == 0) {
      best = warp_v[lane];
      best_i = warp_i[lane];
      for (int off = 16; off > 0; off >>= 1) {
        const float ov = __shfl_down_sync(0xffffffffu, best, off);
        const int oi = __shfl_down_sync(0xffffffffu, best_i, off);
        better(best, best_i, ov, oi);
      }
      if (lane == 0) {
        last_s = best_i;
        out[static_cast<int64_t>(b) * m + step] = best_i;
      }
    }
    __syncthreads();
  }
}

}  // namespace

extern "C" int fps_launch(const float* pos, int b, int n, int m,
                          int64_t* out, void* stream) {
  const size_t smem = sizeof(float) * 4 * static_cast<size_t>(n);
  cudaError_t err = cudaFuncSetAttribute(
      fps_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  fps_kernel<<<b, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      pos, n, m, out);
  return static_cast<int>(cudaGetLastError());
}
