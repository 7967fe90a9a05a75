// Gaussian gradient magnitude on Hopper: one streaming pass over the volume.
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
// agree to the last bit.
//
// What bounds it: 8 bytes a voxel (one f32 read, one written), 2 x 67 MB
// per batch at B=8, 128^3: 40 us at 3.35 TB/s. Its ~86 flops a voxel
// (8 passes of 2r+1 taps, a multiply and an add each, and the magnitude)
// may not contract into FMAs, so they issue as ~86 instructions: ~43 us at
// the CUDA cores' 33.5 T instructions/s, about the byte bound.
//
// Design: a block owns kTH = 8 full-width rows (W <= TW, TW = 128 or 256)
// of one batch element and walks kTD = 32 planes along D, so the volume is
// read once from device memory (plus 2r halo rows and 2r halo planes per
// block, mostly from L2), each input plane of (kTH + 2r) rows as float4
// with clamped (edge-replicated) row and column indices; W borders need no
// halo loads because a row is whole. The radius r = 1..8 is a template
// parameter (scipy's int(4 sigma + 0.5), so sigma < 2.125): this source
// builds radii 1..4 by default and radii 5..8 with -DGGM_WIDE_RADII (a
// second library, built on first use, so that the common radii build as
// fast as they would alone). Each thread owns two float4 positions of the
// plane (three when r > 4, so that the 8 + 2r rows fit) and keeps their
// last 2r + 1 planes in registers (a sliding
// window, unrolled by 2r + 1 so every window slot is a fixed register), so
// the D pass (k1 and k0 variants) reads no shared memory; its results go to
// shared memory once. The H pass gives each thread one column and a run of
// four rows, read once with their 2r halo rows; its three variants go to
// shared memory once, with r edge copies at both ends of a row (in a pad
// of 4 columns, 8 when r > 4). The W pass gives each thread four
// consecutive outputs of a row, read as three float4 per variant (five
// when r > 4), and stores the magnitude as one float4. Two barriers a
// plane; the next plane's loads are issued before the current plane's
// arithmetic. Tile sizes are compile-time constants: no div/mod in a loop.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kTH = 8;       // output rows per block
constexpr int kTD = 32;      // output planes per block
#ifdef GGM_WIDE_RADII
constexpr int kMinR = 5, kMaxR = 8;
#else
constexpr int kMinR = 1, kMaxR = 4;
#endif

// shared-memory columns before column 0 (and after column W - 1): the
// radius rounded up to a whole float4
__host__ __device__ constexpr int pad_of(int r) { return (r + 3) / 4 * 4; }

struct Taps {
  float k0[2 * kMaxR + 1];
  float k1[2 * kMaxR + 1];
};

__device__ __forceinline__ float madd_rn(float acc, float w, float x) {
  return __fadd_rn(acc, __fmul_rn(w, x));
}

__device__ __forceinline__ float4 madd4_rn(float4 acc, float w, float4 x) {
  return make_float4(madd_rn(acc.x, w, x.x), madd_rn(acc.y, w, x.y),
                     madd_rn(acc.z, w, x.z), madd_rn(acc.w, w, x.w));
}

// Columns c..c+3 of a row, each clamped to [0, W-1]; one float4 load where
// all four lie inside a row whose length is a multiple of 4.
__device__ __forceinline__ float4 load4(const float* __restrict__ row, int c,
                                        int W, bool vec) {
  if (vec && c + 3 < W) return __ldg(reinterpret_cast<const float4*>(row + c));
  return make_float4(__ldg(row + min(c, W - 1)), __ldg(row + min(c + 1, W - 1)),
                     __ldg(row + min(c + 2, W - 1)),
                     __ldg(row + min(c + 3, W - 1)));
}

template <int R, int TW>
__global__ void __launch_bounds__(2 * TW, TW == 128 ? 2 : 1)
ggm_kernel(const float* __restrict__ vol, int D, int H, int W, Taps taps,
           float* __restrict__ out) {
  constexpr int T = 2 * R + 1;
  constexpr int kHR = kTH + 2 * R;          // input rows of a plane
  constexpr int kU = TW / 4;                // float4 units per row
  constexpr int kSlots = (kHR + 7) / 8;     // D-pass rows a thread (8 a pass)
  constexpr int kPad = pad_of(R);
  constexpr int kStride = TW + 2 * kPad;    // H-pass row, floats
  constexpr int kWX = 4 + 2 * kPad;         // W-pass inputs of four outputs
  static_assert(kHR <= 8 * kSlots, "halo rows exceed the D-pass slots");

  extern __shared__ __align__(16) float smem[];
  // D pass [k1 | k0][kHR][TW], then H pass [D, H, W dirs][kTH][kStride]
  float (*dp)[kHR][TW] = reinterpret_cast<float (*)[kHR][TW]>(smem);
  float (*hp)[kTH][kStride] =
      reinterpret_cast<float (*)[kTH][kStride]>(smem + 2 * kHR * TW);

  const int t = threadIdx.x;
  const int h0 = blockIdx.x * kTH;
  const int d0 = blockIdx.y * kTD;
  const int n_out = min(kTD, D - d0);
  const bool vec = (W & 3) == 0;
  const float* v = vol + static_cast<int64_t>(blockIdx.z) * D * H * W;
  float* o = out + static_cast<int64_t>(blockIdx.z) * D * H * W;

  // D pass: this thread's columns and (up to) two halo rows of the plane
  const int dc = (t % kU) * 4;
  const int dr = t / kU;                    // 0..7, then + 8, + 16
  int roff[kSlots];
  bool rlive[kSlots];
#pragma unroll
  for (int k = 0; k < kSlots; ++k) {
    const int r = dr + 8 * k;
    rlive[k] = r < kHR;
    roff[k] = min(max(h0 - R + r, 0), H - 1) * W;
  }
  auto load_plane = [&](int rel, float4 (&dst)[kSlots]) {
    const int dd = min(max(d0 - R + rel, 0), D - 1);
    const float* pl = v + static_cast<int64_t>(dd) * H * W;
#pragma unroll
    for (int k = 0; k < kSlots; ++k)
      if (rlive[k]) dst[k] = load4(pl + roff[k], dc, W, vec);
  };

  // H pass: one column, rows hr0..hr0+3
  const int hc = t % TW;
  const int hr0 = (t / TW) * 4;
  // W pass: four consecutive outputs of one row
  const int wr = t / kU;                    // 0..7
  const int wc = (t % kU) * 4;
  const bool w_live = wc < W && h0 + wr < H;

  float4 win[kSlots][T];
  float4 nxt[kSlots];
#pragma unroll
  for (int i = 0; i < 2 * R; ++i) {
    float4 tmp[kSlots];
    load_plane(i, tmp);
#pragma unroll
    for (int k = 0; k < kSlots; ++k) win[k][i] = tmp[k];
  }
  load_plane(2 * R, nxt);

  for (int base = 0; base < n_out; base += T) {
#pragma unroll
    for (int j = 0; j < T; ++j) {
      const int step = base + j;
      if (step >= n_out) break;
      // the plane d0 + step + R enters the window; the next one is issued
#pragma unroll
      for (int k = 0; k < kSlots; ++k) win[k][(j + 2 * R) % T] = nxt[k];
      if (step + 1 < n_out) load_plane(step + 1 + 2 * R, nxt);

      // ---- D pass, from registers ----
#pragma unroll
      for (int k = 0; k < kSlots; ++k) {
        if (!rlive[k]) continue;
        float4 a1 = make_float4(0.f, 0.f, 0.f, 0.f), a0 = a1;
#pragma unroll
        for (int i = 0; i < T; ++i) {
          const float4 x = win[k][(j + i) % T];
          a1 = madd4_rn(a1, taps.k1[i], x);
          a0 = madd4_rn(a0, taps.k0[i], x);
        }
        *reinterpret_cast<float4*>(&dp[0][dr + 8 * k][dc]) = a1;
        *reinterpret_cast<float4*>(&dp[1][dr + 8 * k][dc]) = a0;
      }
      __syncthreads();

      // ---- H pass: a run of four rows from one read of 4 + 2r rows ----
      {
        float x1[4 + 2 * R], x0[4 + 2 * R];
#pragma unroll
        for (int i = 0; i < 4 + 2 * R; ++i) {
          x1[i] = dp[0][hr0 + i][hc];
          x0[i] = dp[1][hr0 + i][hc];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          float gd = 0.f, gh = 0.f, gw = 0.f;
#pragma unroll
          for (int i = 0; i < T; ++i) {
            gd = madd_rn(gd, taps.k0[i], x1[r + i]);
            gh = madd_rn(gh, taps.k1[i], x0[r + i]);
            gw = madd_rn(gw, taps.k0[i], x0[r + i]);
          }
          const float g[3] = {gd, gh, gw};
#pragma unroll
          for (int q = 0; q < 3; ++q) {
            float* row = &hp[q][hr0 + r][kPad];
            if (hc < W) row[hc] = g[q];
            // edge copies: columns -R..-1 and W..W+R-1
            if (hc == 0) {
#pragma unroll
              for (int e = 1; e <= R; ++e) row[-e] = g[q];
            }
            if (hc == W - 1) {
#pragma unroll
              for (int e = 1; e <= R; ++e) row[W - 1 + e] = g[q];
            }
          }
        }
      }
      __syncthreads();

      // ---- W pass and magnitude: four outputs from kWX / 4 float4 reads --
      if (w_live) {
        float x[3][kWX];
#pragma unroll
        for (int q = 0; q < 3; ++q)
#pragma unroll
          for (int u = 0; u < kWX / 4; ++u) {
            const float4 f =
                *reinterpret_cast<const float4*>(&hp[q][wr][wc + 4 * u]);
            x[q][4 * u] = f.x;
            x[q][4 * u + 1] = f.y;
            x[q][4 * u + 2] = f.z;
            x[q][4 * u + 3] = f.w;
          }
        float m[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float gd = 0.f, gh = 0.f, gw = 0.f;
#pragma unroll
          for (int i = 0; i < T; ++i) {
            // column wc + c - R + i sits at wc + c - R + i + kPad
            const int s = c + kPad - R + i;
            gd = madd_rn(gd, taps.k0[i], x[0][s]);
            gh = madd_rn(gh, taps.k0[i], x[1][s]);
            gw = madd_rn(gw, taps.k1[i], x[2][s]);
          }
          m[c] = __fsqrt_rn(__fadd_rn(
              __fadd_rn(__fmul_rn(gd, gd), __fmul_rn(gh, gh)),
              __fmul_rn(gw, gw)));
        }
        float* dst = o + (static_cast<int64_t>(d0 + step) * H + h0 + wr) * W +
                     wc;
        if (vec) {
          *reinterpret_cast<float4*>(dst) = make_float4(m[0], m[1], m[2], m[3]);
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (wc + c < W) dst[c] = m[c];
        }
      }
    }
  }
}

template <int R, int TW>
int launch(const float* vol, int B, int D, int H, int W, const Taps& taps,
           float* out, cudaStream_t stream) {
  constexpr int smem =
      4 * (2 * (kTH + 2 * R) * TW + 3 * kTH * (TW + 2 * pad_of(R)));
  cudaError_t err = cudaFuncSetAttribute(
      ggm_kernel<R, TW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((H + kTH - 1) / kTH, (D + kTD - 1) / kTD, B);
  ggm_kernel<R, TW><<<grid, 2 * TW, smem, stream>>>(vol, D, H, W, taps, out);
  return static_cast<int>(cudaGetLastError());
}

template <int TW>
int launch_r(int radius, const float* vol, int B, int D, int H, int W,
             const Taps& taps, float* out, cudaStream_t s) {
  switch (radius) {
#ifdef GGM_WIDE_RADII
    case 5: return launch<5, TW>(vol, B, D, H, W, taps, out, s);
    case 6: return launch<6, TW>(vol, B, D, H, W, taps, out, s);
    case 7: return launch<7, TW>(vol, B, D, H, W, taps, out, s);
    default: return launch<8, TW>(vol, B, D, H, W, taps, out, s);
#else
    case 1: return launch<1, TW>(vol, B, D, H, W, taps, out, s);
    case 2: return launch<2, TW>(vol, B, D, H, W, taps, out, s);
    case 3: return launch<3, TW>(vol, B, D, H, W, taps, out, s);
    default: return launch<4, TW>(vol, B, D, H, W, taps, out, s);
#endif
  }
}

}  // namespace

extern "C" int ggm_launch(const float* vol, int B, int D, int H, int W,
                          const float* k0, const float* k1, int radius,
                          float* out, void* stream) {
  if (radius < kMinR || radius > kMaxR || B < 1 || B > 65535 || D < 1 ||
      H < 1 || W < 1 || W > 256 || (H + kTH - 1) / kTH > 65535 ||
      (D + kTD - 1) / kTD > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Taps taps;
  for (int i = 0; i < 2 * radius + 1; ++i) {
    taps.k0[i] = k0[i];
    taps.k1[i] = k1[i];
  }
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (W <= 128) return launch_r<128>(radius, vol, B, D, H, W, taps, out, s);
  return launch_r<256>(radius, vol, B, D, H, W, taps, out, s);
}
