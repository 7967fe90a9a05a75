// Fused dense-lattice decode on Hopper: trilinear upsample + MLP chain + head.
//
// Replaces the TPU kernel garmentnets_tpu/ops/dense_decode_pallas.py
// (decode_tiles_pallas, driven by dense_decode_fused).
//
// For each fine voxel (b, d, h, w) of the S^3 lattice:
//   a   = relu(trilinear(z)[b, d, h, w, :]) * g0 + s0     z: coarse layer-0
//   a   = relu(a @ K_l + b_l) * g_l + s_l                  each hidden layer
//   out = relu(a . k_head + b_head) * g_head + s_head      scalar head
// (head holds k_head [C_last] followed by b_head, g_head, s_head)
// where z = fv @ K0 + b0 on the coarse grid is computed outside the kernel
// (layer 0 commutes with interpolation). The interpolation taps are the
// align-corners pairs of ops/dense_decode.axis_plan, applied in the order
// (D, then H, then W). Nothing of the fine lattice but the output touches
// device memory.
//
// What bounds it: ~2.2 TFLOP per batch at B=8, 128^3, one 256x256 hidden
// layer, against 0.27 GB read and 0.07 GB written: it is bound by operations.
// This first version computes in f32 on the CUDA cores (67 TFLOP/s peak), so
// it is at least as accurate as the JAX engine's bf16_3x default. Its design:
// a block owns 64 consecutive fine voxels of one (b, d, h) line and keeps
// their activations in shared memory ([64 x 256] f32, twice, for in and out
// of a layer); each hidden layer is a shared-memory-tiled product where each
// of 256 threads holds an 8x8 register tile, with the weight matrix streamed
// through shared memory 32 rows at a time (it stays in L2). A wgmma/TMA
// redesign with tensor-core precision tiers is later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;      // fine voxels per block (along W)
constexpr int kThreads = 256;
constexpr int kCMax = 256;     // max layer width
constexpr int kKc = 32;        // weight rows per shared-memory chunk
constexpr int kMaxMid = 8;
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kRows * kCMax + kKc * kCMax);

struct Dims {
  int n_mid;
  int width[kMaxMid + 1];  // width[0] = C1, width[l+1] = out width of mid l
};

struct Taps {
  const int* lo_d; const float* w_d;
  const int* lo_h; const float* w_h;
  const int* lo_w; const float* w_w;
};

__global__ void __launch_bounds__(kThreads)
decode_kernel(const float* __restrict__ z, int Dc, int Hc, int Wc, int S,
              Taps taps, const float* __restrict__ aff0,
              const float* __restrict__ mids, Dims dims,
              const float* __restrict__ head, float* __restrict__ out) {
  extern __shared__ float smem[];
  float* act = smem;                       // [kRows][kCMax]
  float* nxt = act + kRows * kCMax;        // [kRows][kCMax]
  float* ks = nxt + kRows * kCMax;         // [kKc][kCMax]

  const int n_wt = (S + kRows - 1) / kRows;
  int64_t blk = blockIdx.x;
  const int wt = static_cast<int>(blk % n_wt); blk /= n_wt;
  const int h = static_cast<int>(blk % S); blk /= S;
  const int d = static_cast<int>(blk % S); blk /= S;
  const int b = static_cast<int>(blk);
  const int w0 = wt * kRows;
  const int t = threadIdx.x;
  const int C1 = dims.width[0];

  // ---- trilinear upsample of the coarse pre-activations, relu*g0+s0 ----
  {
    const int dl = taps.lo_d[d], hl = taps.lo_h[h];
    const float wd0 = taps.w_d[2 * d], wd1 = taps.w_d[2 * d + 1];
    const float wh0 = taps.w_h[2 * h], wh1 = taps.w_h[2 * h + 1];
    const int64_t sw = C1;
    const int64_t sh = sw * Wc;
    const int64_t sd = sh * Hc;
    const float* zb = z + static_cast<int64_t>(b) * Dc * sd;
    for (int c = t; c < C1; c += kThreads) {
      const float g0 = aff0[c], s0 = aff0[C1 + c];
      for (int r = 0; r < kRows; ++r) {
        const int w = w0 + r;
        if (w >= S) break;
        const int wl = taps.lo_w[w];
        const float ww0 = taps.w_w[2 * w], ww1 = taps.w_w[2 * w + 1];
        float zh[2];
        for (int k = 0; k < 2; ++k) {
          const float* p = zb + dl * sd + hl * sh + (wl + k) * sw + c;
          const float z00 = wd0 * p[0] + wd1 * p[sd];            // h lo
          const float z10 = wd0 * p[sh] + wd1 * p[sd + sh];      // h hi
          zh[k] = wh0 * z00 + wh1 * z10;
        }
        const float v = ww0 * zh[0] + ww1 * zh[1];
        act[r * kCMax + c] = fmaxf(v, 0.0f) * g0 + s0;
      }
    }
  }
  __syncthreads();

  // ---- hidden layers: act[64 x cin] @ K[cin x cout] -> relu*g+s ----
  const int tx = t & 31;   // columns tx + 32*j
  const int ty = t >> 5;   // rows ty*8 + i
  const float* prm = mids;
  for (int l = 0; l < dims.n_mid; ++l) {
    const int cin = dims.width[l], cout = dims.width[l + 1];
    const float* K = prm;
    const float* bias = K + static_cast<int64_t>(cin) * cout;
    const float* g = bias + cout;
    const float* s = g + cout;
    prm = s + cout;
    float acc[8][8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = 0.0f;
    for (int k0 = 0; k0 < cin; k0 += kKc) {
      for (int e = t; e < kKc * kCMax; e += kThreads) {
        const int row = e / kCMax, col = e % kCMax;
        ks[e] = (k0 + row < cin && col < cout)
                    ? K[static_cast<int64_t>(k0 + row) * cout + col] : 0.0f;
      }
      __syncthreads();
      const int kn = min(kKc, cin - k0);
      for (int kk = 0; kk < kn; ++kk) {
        float a[8], w[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) a[i] = act[(ty * 8 + i) * kCMax + k0 + kk];
#pragma unroll
        for (int j = 0; j < 8; ++j) w[j] = ks[kk * kCMax + tx + 32 * j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
      }
      __syncthreads();
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = tx + 32 * j;
      if (col >= cout) continue;
      const float bj = bias[col], gj = g[col], sj = s[col];
#pragma unroll
      for (int i = 0; i < 8; ++i)
        nxt[(ty * 8 + i) * kCMax + col] = fmaxf(acc[i][j] + bj, 0.0f) * gj + sj;
    }
    __syncthreads();
    float* tmp = act; act = nxt; nxt = tmp;
  }

  // ---- scalar head: one warp per row, lanes split the channels ----
  const int c_last = dims.width[dims.n_mid];
  const float head_b = head[c_last], head_g = head[c_last + 1],
              head_s = head[c_last + 2];
  const int lane = t & 31, warp = t >> 5;
  float* ob = out + ((static_cast<int64_t>(b) * S + d) * S + h) * S;
  for (int r = warp; r < kRows; r += kThreads / 32) {
    float sum = 0.0f;
    for (int c = lane; c < c_last; c += 32) sum += act[r * kCMax + c] * head[c];
    for (int off = 16; off > 0; off >>= 1)
      sum += __shfl_xor_sync(0xffffffffu, sum, off);
    if (lane == 0 && w0 + r < S)
      ob[w0 + r] = fmaxf(sum + head_b, 0.0f) * head_g + head_s;
  }
}

}  // namespace

extern "C" int dense_decode_launch(
    const float* z, int B, int Dc, int Hc, int Wc, int S,
    const int* lo_d, const float* w_d, const int* lo_h, const float* w_h,
    const int* lo_w, const float* w_w, const float* aff0, const float* mids,
    int n_mid, const int* widths, const float* head, float* out,
    void* stream) {
  if (n_mid < 0 || n_mid > kMaxMid) return static_cast<int>(cudaErrorInvalidValue);
  Dims dims;
  dims.n_mid = n_mid;
  for (int i = 0; i <= n_mid; ++i) {
    if (widths[i] < 1 || widths[i] > kCMax)
      return static_cast<int>(cudaErrorInvalidValue);
    dims.width[i] = widths[i];
  }
  Taps taps{lo_d, w_d, lo_h, w_h, lo_w, w_w};
  cudaError_t err = cudaFuncSetAttribute(
      decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(kSmemBytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t n_wt = (S + kRows - 1) / kRows;
  const int64_t blocks = static_cast<int64_t>(B) * S * S * n_wt;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  decode_kernel<<<static_cast<unsigned>(blocks), kThreads, kSmemBytes,
                  static_cast<cudaStream_t>(stream)>>>(
      z, Dc, Hc, Wc, S, taps, aff0, mids, dims, head, out);
  return static_cast<int>(cudaGetLastError());
}
