// Fused eval-mode set abstraction on Hopper: neighbour gather + BN-folded
// MLP chain + masked max over the neighbour slots.
//
// Replaces the TPU kernel garmentnets_tpu/kernels/sa_pallas.py (sa_fused,
// kernel body _sa_kernel).
//
// For batch row b, center m and neighbour slot k, with j = idx[b, m, k]:
//   h = concat(x[b, j], pos[b, j] - centers[b, m])
//   h = relu(h @ K_l + b_l) * g_l + s_l           for each layer l
//   out[b, m] = max over the slots k with mask[b, m, k] of h
// A center with no valid slot gives -inf, as the plain version does.
//
// What bounds it: at B=8, K=64 the two stage-1 calls do 38.9 and 50.6 GFLOP
// of f32 products against ~50 MB read each: bound by operations. Unlike the
// TPU kernel (Mosaic cannot gather, so the gathered [B, K, M, C] tensor made
// a trip through HBM), each block gathers its neighbour rows from global
// memory itself. Its design: a block owns 64 neighbour rows, i.e. the
// 64 / Kp centers whose (padded) slots they are, and keeps their activations
// in shared memory channel-major ([C][64 + 4], the pad spreads the
// epilogue's stores over the banks) for the input and output of a layer.
// Each layer is a shared-memory-tiled f32 product in which each of 256
// threads holds an 8-row x TC-column register tile (TC = cout / 32; the
// wrapper pads every width to a multiple of 32 with zero weights), with the
// weights streamed through shared memory 32 rows at a time (they stay in
// L2; SA2's 264 KB of weights do not fit in one SM). The last layer's
// epilogue folds the masked max over the slots into registers and one
// small shared-memory pass, so the widest activation is never stored.
// Invalid slots are not gathered (their rows are zeros) and are left out of
// the max. f32 on the CUDA cores; tensor cores are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kRows = 64;              // neighbour rows per block
constexpr int kRowStride = kRows + 4;  // channel-major row stride (floats)
constexpr int kThreads = 256;
constexpr int kKc = 32;                // weight rows per shared-memory chunk
constexpr int kMaxLayers = 8;
constexpr int kMaxWidth = 256;
constexpr size_t kMaxSmem = 232448;

struct Dims {
  int n_layers;
  int cbuf;                  // channels of each activation buffer
  int cmax;                  // widest padded layer output
  int cout[kMaxLayers];      // padded output width of each layer
  int cout_last;             // real output width of the last layer
};

// One layer on the block's 64 rows: act [cin][kRowStride] -> either nxt
// (a hidden layer) or, for the last layer, the masked max of each center
// written to out_b[m * cout_last + col].
template <int TC>
__device__ __forceinline__ void mlp_layer(
    const float* __restrict__ prm, int cin, const float* act, float* nxt,
    float* ks, const int* s_valid, bool last, float* __restrict__ out_b,
    int m0, int M, int Kp, int cout_last) {
  constexpr int kCout = 32 * TC;
  const int t = threadIdx.x;
  const int tx = t & 31;   // columns tx + 32 * j
  const int ty = t >> 5;   // rows ty * 8 + i
  const float* K = prm;
  const float* bias = K + static_cast<int64_t>(cin) * kCout;
  const float* g = bias + kCout;
  const float* s = g + kCout;

  float acc[8][TC];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < TC; ++j) acc[i][j] = 0.0f;

  for (int k0 = 0; k0 < cin; k0 += kKc) {
    const int kn = min(kKc, cin - k0);
    const float* src = K + static_cast<int64_t>(k0) * kCout;
    for (int e = t; e < kn * kCout; e += kThreads) ks[e] = src[e];
    __syncthreads();
    for (int kk = 0; kk < kn; ++kk) {
      const float4* ap = reinterpret_cast<const float4*>(
          act + (k0 + kk) * kRowStride + ty * 8);
      const float4 a0 = ap[0], a1 = ap[1];
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      float w[TC];
#pragma unroll
      for (int j = 0; j < TC; ++j) w[j] = ks[kk * kCout + tx + 32 * j];
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < TC; ++j) acc[i][j] = fmaf(a[i], w[j], acc[i][j]);
    }
    __syncthreads();
  }

  if (!last) {
#pragma unroll
    for (int j = 0; j < TC; ++j) {
      const int col = tx + 32 * j;
      const float bj = bias[col], gj = g[col], sj = s[col];
      float v[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = fmaxf(acc[i][j] + bj, 0.0f) * gj + sj;
      float4* dst = reinterpret_cast<float4*>(nxt + col * kRowStride + ty * 8);
      dst[0] = make_float4(v[0], v[1], v[2], v[3]);
      dst[1] = make_float4(v[4], v[5], v[6], v[7]);
    }
    return;
  }

  // last layer: max over this thread's valid rows, then over the 8-row
  // groups of each center (ks is free: the product loop ended on a barrier)
#pragma unroll
  for (int j = 0; j < TC; ++j) {
    const int col = tx + 32 * j;
    const float bj = bias[col], gj = g[col], sj = s[col];
    float mx = -INFINITY;
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float v = fmaxf(acc[i][j] + bj, 0.0f) * gj + sj;
      if (s_valid[ty * 8 + i]) mx = fmaxf(mx, v);
    }
    ks[ty * kCout + col] = mx;
  }
  __syncthreads();
  const int groups = Kp / 8;          // 8-row groups per center
  const int cpb = kRows / Kp;         // centers per block
  for (int e = t; e < cpb * cout_last; e += kThreads) {
    const int c = e / cout_last, col = e % cout_last;
    const int m = m0 + c;
    if (m >= M) continue;
    float mx = ks[c * groups * kCout + col];
    for (int q = 1; q < groups; ++q)
      mx = fmaxf(mx, ks[(c * groups + q) * kCout + col]);
    out_b[static_cast<int64_t>(m) * cout_last + col] = mx;
  }
}

__global__ void __launch_bounds__(kThreads, 2)
sa_kernel(const float* __restrict__ x, const float* __restrict__ pos,
          const float* __restrict__ centers,
          const long long* __restrict__ idx,
          const unsigned char* __restrict__ mask, int N, int M, int Cin,
          int Kp, const float* __restrict__ params, Dims dims,
          float* __restrict__ out) {
  extern __shared__ __align__(16) float smem[];
  float* act = smem;                              // [cbuf][kRowStride]
  float* nxt = act + dims.cbuf * kRowStride;      // [cbuf][kRowStride]
  float* ks = nxt + dims.cbuf * kRowStride;       // [kKc][cmax]
  int* s_idx = reinterpret_cast<int*>(ks + kKc * dims.cmax);
  int* s_valid = s_idx + kRows;

  const int cpb = kRows / Kp;
  const int n_mt = (M + cpb - 1) / cpb;
  const int b = blockIdx.x / n_mt;
  const int m0 = (blockIdx.x % n_mt) * cpb;
  const int t = threadIdx.x;

  if (t < kRows) {
    const int m = m0 + t / Kp;
    int valid = 0, j = 0;
    if (m < M) {
      const int64_t o = (static_cast<int64_t>(b) * M + m) * Kp + t % Kp;
      valid = mask[o] != 0;
      // clamped so that an index out of range cannot read out of bounds;
      // ball query gives indices in [0, N)
      const long long v = idx[o];
      j = static_cast<int>(v < 0 ? 0 : (v >= N ? N - 1 : v));
    }
    s_idx[t] = j;
    s_valid[t] = valid;
  }
  __syncthreads();

  // gather: act[c][r] = concat(x[b, j_r], pos[b, j_r] - centers[b, m_r])
  const int cin0 = Cin + 3;
  for (int e = t; e < kRows * cin0; e += kThreads) {
    const int r = e / cin0, c = e % cin0;
    float v = 0.0f;
    if (s_valid[r]) {
      const int64_t p = static_cast<int64_t>(b) * N + s_idx[r];
      if (c < Cin) {
        v = x[p * Cin + c];
      } else {
        const int64_t cm = static_cast<int64_t>(b) * M + m0 + r / Kp;
        v = pos[p * 3 + (c - Cin)] - centers[cm * 3 + (c - Cin)];
      }
    }
    act[c * kRowStride + r] = v;
  }
  __syncthreads();

  const float* prm = params;
  float* out_b = out + static_cast<int64_t>(b) * M * dims.cout_last;
  int cin = cin0;
  for (int l = 0; l < dims.n_layers; ++l) {
    const int cout = dims.cout[l];
    const bool last = l == dims.n_layers - 1;
    switch (cout / 32) {
#define SA_LAYER(TC)                                                      \
  case TC:                                                                \
    mlp_layer<TC>(prm, cin, act, nxt, ks, s_valid, last, out_b, m0, M, Kp, \
                  dims.cout_last);                                        \
    break;
      SA_LAYER(1) SA_LAYER(2) SA_LAYER(3) SA_LAYER(4)
      SA_LAYER(5) SA_LAYER(6) SA_LAYER(7) SA_LAYER(8)
#undef SA_LAYER
    }
    if (last) break;
    __syncthreads();
    prm += static_cast<int64_t>(cin) * cout + 3 * cout;
    float* tmp = act; act = nxt; nxt = tmp;
    cin = cout;
  }
}

}  // namespace

// params: per layer K [cin_l][cout_l] (cin_0 = Cin + 3, cin_l = cout_{l-1})
// then b, g, s [cout_l], every cout_l a multiple of 32 (zero-padded).
extern "C" int sa_launch(const float* x, const float* pos,
                         const float* centers, const long long* idx,
                         const unsigned char* mask, int B, int N, int M,
                         int Cin, int Kp, const float* params, int n_layers,
                         const int* couts, int cout_last, float* out,
                         void* stream) {
  if (B < 1 || N < 1 || M < 1 || Cin < 0 || n_layers < 1 ||
      n_layers > kMaxLayers || (Kp != 8 && Kp != 16 && Kp != 32 && Kp != 64))
    return static_cast<int>(cudaErrorInvalidValue);
  Dims dims;
  dims.n_layers = n_layers;
  dims.cbuf = Cin + 3;
  dims.cmax = 0;
  for (int l = 0; l < n_layers; ++l) {
    const int c = couts[l];
    if (c < 32 || c > kMaxWidth || c % 32 != 0)
      return static_cast<int>(cudaErrorInvalidValue);
    dims.cout[l] = c;
    if (c > dims.cmax) dims.cmax = c;
    if (l + 1 < n_layers && c > dims.cbuf) dims.cbuf = c;
  }
  if (cout_last < 1 || cout_last > couts[n_layers - 1] ||
      cout_last <= couts[n_layers - 1] - 32)
    return static_cast<int>(cudaErrorInvalidValue);
  dims.cout_last = cout_last;
  const size_t smem = sizeof(float) * (2 * static_cast<size_t>(dims.cbuf) *
                                           kRowStride + kKc * dims.cmax) +
                      sizeof(int) * 2 * kRows;
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      sa_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int64_t cpb = kRows / Kp;
  const int64_t blocks = static_cast<int64_t>(B) * ((M + cpb - 1) / cpb);
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  sa_kernel<<<static_cast<unsigned>(blocks), kThreads, smem,
              static_cast<cudaStream_t>(stream)>>>(
      x, pos, centers, idx, mask, N, M, Cin, Kp, params, dims, out);
  return static_cast<int>(cudaGetLastError());
}
