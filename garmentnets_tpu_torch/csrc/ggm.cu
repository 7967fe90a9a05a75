// Gaussian gradient magnitude on Hopper: one pass over the volume.
//
// Replaces the TPU kernel garmentnets_tpu/ops/gaussian_pallas.py (ggm_pallas).
//
// Computes scipy.ndimage.gaussian_gradient_magnitude(mode='nearest') over
// the last three axes of a [B, D, H, W] f32 volume: for each direction a,
// g_a = separable correlation with the derivative-of-gaussian taps k1 along
// axis a and the gaussian taps k0 along the other two, applied D, then H,
// then W, each with edge-replicated borders; out = sqrt(g_D^2 + g_H^2 +
// g_W^2). Each tap is accumulated as acc + w*x with explicitly rounded
// operations (no FMA contraction), in the plain version's order, so the two
// agree to the last bit or close to it.
//
// What bounds it: ~95 operations per voxel against 8 bytes (one f32 read,
// one written), so it is bound by memory: 2 x 67 MB per batch at B=8, 128^3,
// about 40 us at 3.35 TB/s. Its design keeps every intermediate on chip: a
// block loads a (TD+2r) x (TH+2r) x (TW+2r) tile of the volume with clamped
// (edge-replicated) halo into shared memory, runs the D pass (two variants:
// k1 and k0), the H pass (three variants) and the W pass there, and writes
// only the magnitude. The halo re-reads neighbouring tiles' voxels, which
// mostly come from L2.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTD = 4, kTH = 8, kTW = 32;
constexpr int kMaxR = 4;
constexpr int kThreads = 256;

struct Taps {
  float k0[2 * kMaxR + 1];
  float k1[2 * kMaxR + 1];
};

__device__ __forceinline__ float madd_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

template <int R>
__global__ void __launch_bounds__(kThreads)
ggm_kernel(const float* __restrict__ vol, int D, int H, int W, Taps taps,
           float* __restrict__ out) {
  constexpr int T = 2 * R + 1;
  constexpr int HD = kTD + 2 * R, HH = kTH + 2 * R, HW = kTW + 2 * R;
  // halo tile, D pass (k1 | k0), H pass (3 directions)
  extern __shared__ float smem[];
  float* tile = smem;
  float (*dpass)[kTD * HH * HW] =
      reinterpret_cast<float (*)[kTD * HH * HW]>(tile + HD * HH * HW);
  float (*hpass)[kTD * kTH * HW] =
      reinterpret_cast<float (*)[kTD * kTH * HW]>(dpass[2]);

  const int n_wt = (W + kTW - 1) / kTW;
  const int n_ht = (H + kTH - 1) / kTH;
  const int wt = blockIdx.x % n_wt;
  const int ht = blockIdx.x / n_wt;
  if (ht >= n_ht) return;
  const int d0 = blockIdx.y * kTD, h0 = ht * kTH, w0 = wt * kTW;
  const int b = blockIdx.z;
  const float* v = vol + static_cast<int64_t>(b) * D * H * W;

  for (int e = threadIdx.x; e < HD * HH * HW; e += kThreads) {
    const int x = e % HW, y = (e / HW) % HH, zz = e / (HW * HH);
    const int dd = min(max(d0 + zz - R, 0), D - 1);
    const int hh = min(max(h0 + y - R, 0), H - 1);
    const int ww = min(max(w0 + x - R, 0), W - 1);
    tile[e] = v[(static_cast<int64_t>(dd) * H + hh) * W + ww];
  }
  __syncthreads();

  // D pass: [kTD, HH, HW] with k1 (direction D) and k0 (directions H, W)
  for (int e = threadIdx.x; e < kTD * HH * HW; e += kThreads) {
    const int x = e % HW, y = (e / HW) % HH, zz = e / (HW * HH);
    float a1 = 0.0f, a0 = 0.0f;
#pragma unroll
    for (int i = 0; i < T; ++i) {
      const float t = tile[((zz + i) * HH + y) * HW + x];
      a1 = madd_rn(a1, taps.k1[i], t);
      a0 = madd_rn(a0, taps.k0[i], t);
    }
    dpass[0][e] = a1;
    dpass[1][e] = a0;
  }
  __syncthreads();

  // H pass: [kTD, kTH, HW]; direction D: k0 on dpass[0], H: k1 on
  // dpass[1], W: k0 on dpass[1]
  for (int e = threadIdx.x; e < kTD * kTH * HW; e += kThreads) {
    const int x = e % HW, y = (e / HW) % kTH, zz = e / (HW * kTH);
    float gd = 0.0f, gh = 0.0f, gw = 0.0f;
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int src = (zz * HH + y + j) * HW + x;
      gd = madd_rn(gd, taps.k0[j], dpass[0][src]);
      gh = madd_rn(gh, taps.k1[j], dpass[1][src]);
      gw = madd_rn(gw, taps.k0[j], dpass[1][src]);
    }
    hpass[0][e] = gd;
    hpass[1][e] = gh;
    hpass[2][e] = gw;
  }
  __syncthreads();

  // W pass + magnitude: [kTD, kTH, kTW]; k1 only for direction W
  for (int e = threadIdx.x; e < kTD * kTH * kTW; e += kThreads) {
    const int x = e % kTW, y = (e / kTW) % kTH, zz = e / (kTW * kTH);
    const int d = d0 + zz, h = h0 + y, w = w0 + x;
    if (d >= D || h >= H || w >= W) continue;
    float gd = 0.0f, gh = 0.0f, gw = 0.0f;
#pragma unroll
    for (int k = 0; k < T; ++k) {
      const int src = (zz * kTH + y) * HW + x + k;
      gd = madd_rn(gd, taps.k0[k], hpass[0][src]);
      gh = madd_rn(gh, taps.k0[k], hpass[1][src]);
      gw = madd_rn(gw, taps.k1[k], hpass[2][src]);
    }
    const float acc = __fadd_rn(__fadd_rn(__fmul_rn(gd, gd), __fmul_rn(gh, gh)),
                                __fmul_rn(gw, gw));
    out[(static_cast<int64_t>(b) * D + d) * H * W +
        static_cast<int64_t>(h) * W + w] = __fsqrt_rn(acc);
  }
}

template <int R>
int launch(const float* vol, int B, int D, int H, int W, const Taps& taps,
           float* out, cudaStream_t stream) {
  constexpr int HD = kTD + 2 * R, HH = kTH + 2 * R, HW = kTW + 2 * R;
  constexpr size_t smem =
      sizeof(float) * (HD * HH * HW + 2 * kTD * HH * HW + 3 * kTD * kTH * HW);
  cudaError_t err = cudaFuncSetAttribute(
      ggm_kernel<R>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const int n_wt = (W + kTW - 1) / kTW;
  const int n_ht = (H + kTH - 1) / kTH;
  dim3 grid(n_wt * n_ht, (D + kTD - 1) / kTD, B);
  ggm_kernel<R><<<grid, kThreads, smem, stream>>>(vol, D, H, W, taps, out);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int ggm_launch(const float* vol, int B, int D, int H, int W,
                          const float* k0, const float* k1, int radius,
                          float* out, void* stream) {
  if (radius < 1 || radius > kMaxR || B > 65535 || (D + kTD - 1) / kTD > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int i = 0; i < 2 * radius + 1; ++i) {
    taps.k0[i] = k0[i];
    taps.k1[i] = k1[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (radius) {
    case 1: return launch<1>(vol, B, D, H, W, taps, out, s);
    case 2: return launch<2>(vol, B, D, H, W, taps, out, s);
    case 3: return launch<3>(vol, B, D, H, W, taps, out, s);
    default: return launch<4>(vol, B, D, H, W, taps, out, s);
  }
}
