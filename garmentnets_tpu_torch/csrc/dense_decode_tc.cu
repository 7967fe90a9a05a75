// Fused dense-lattice decode on Hopper's tensor cores (wgmma), at the JAX
// engine's two reduced precision tiers.
//
// Replaces the TPU kernel garmentnets_tpu/ops/dense_decode_pallas.py:123
// (decode_tiles_pallas, driven by dense_decode_fused) at precision HIGH
// (bf16x3, `_mm`) and DEFAULT (one bf16 pass). HIGHEST stays on the f32
// kernel csrc/dense_decode.cu. Same function as that kernel: for each fine
// voxel (b, d, h, w) of the S^3 lattice
//   a   = relu(trilinear(z)[b, d, h, w, :]) * g0 + s0     exact f32
//   a   = relu(a @ K_l + b_l) * g_l + s_l                  each hidden layer
//   out = relu(a . k_head + b_head) * g_head + s_head      f32, CUDA cores
// with z = fv @ K0 + b0 computed outside. The hidden products run on
// wgmma.mma_async (m64 x NP x k16, bf16 in, f32 accumulate):
//   PARTS 2 ('high'):    a_hi.W_hi + a_hi.W_lo + a_lo.W_hi   (as `_mm`)
//   PARTS 1 ('default'): a_hi.W_hi
// where x_hi = bf16(x), x_lo = bf16(x - f32(x_hi)), round to nearest even.
// Where JAX differs: its kernel also sends the W-axis upsample through
// `_mm`; here the whole upsample is exact f32, so at least as accurate.
//
// Bound (B=8, 128^3, 128-256-256-1): one 256x256 product per voxel is
// 2.2 TFLOP per batch, 6.67 ms at bf16x3 (three passes at 989 TFLOP/s) and
// 2.22 ms at one pass; the f32 upsample, affines, splits and head are
// ~0.06 TFLOP on the CUDA cores (~0.9 ms at 67 TFLOP/s, can overlap); bytes
// are 0.34 GB (0.1 ms). Tensor-core operations bound it.
//
// Design, against the four limits of the f32 kernel:
// - f32 on CUDA cores (67 TFLOP/s ceiling): the products go to the tensor
//   cores through wgmma, the only route to their full rate.
// - One shared-memory wavefront per four FMAs: wgmma reads both operands
//   from shared memory itself (SS form) in 128-byte core matrices; no
//   register tiling through shared memory is left on the product's path.
// - One 64-row block per SM hiding little latency: a persistent block per
//   SM owns 128-row tiles (two consumer warpgroups of 64 rows, each with
//   the full N = NP columns in 128 registers a thread) and a producer warp
//   keeps the next weight chunks in flight across tile boundaries, so the
//   upsample and epilogue of one tile overlap the loads of the next.
// - 67 GB of L2 weight reads per batch (256 KB per 64 rows): a tile is
//   128 rows and the weights come as bf16 (W_hi, plus W_lo at 'high'):
//   256 KB per 128 rows at 'high' (~34 GB per batch), 128 KB at 'default'.
// At 'high', W_hi + W_lo of a 256x256 layer (256 KB) do not fit in a
// block's 227 KB beside the activations, so every layer streams its weights
// through a 2-stage ring of 32-row K-chunks: one cp.async.bulk per chunk
// (no tensor map) into an mbarrier, 32 KB a stage at 'high'. The wrapper
// packs each chunk (kernels/dense_decode_tc.pack_wgmma_weights) into the
// exact shared-memory image of the wgmma B operand: K-major, no swizzle,
// 8x8 core matrices of 128 contiguous bytes (LBO 128 B along K, SBO 512 B
// along N). The activations (A operand, hi and lo) live in shared memory in
// the same core-matrix layout (LBO 128 B, SBO NP*16 B): the accumulator
// fragment of a layer maps onto whole core-matrix rows, so the epilogue's
// bf16x2 stores and wgmma's reads are both free of bank conflicts; the RS
// form would need 256 registers a thread at N = 256 (hi + lo fragments +
// accumulator). Upsample: a tile is 128 consecutive voxels of one W-line
// (one full line at S = 128); the D/H interpolation is done once per tile
// into a [window, C1] f32 line buffer, then each row W-interpolates from
// it, with the plain version's roundings. Tiles go in (b, d, h, w) order,
// so the blocks in flight share coarse rows in L2. Widths are zero-padded
// by the wrapper to NP in {64, 128, 256}; padded channels carry exact
// zeros. Shared memory at NP = 256, 'high': 128 KB activations + 64 KB
// ring + 33 KB line buffer.
//
// Where the time goes (tools/profile_decode_tc.py): the phases of a tile
// run one after another, so the tensor cores wait while the CUDA cores
// stage, upsample and split (~50% of the time) and run the epilogue
// (~10%); the products run near the tensor cores' rate between waits on
// the weight ring (~15%, L2 bandwidth). Overlapping the CUDA-core phases
// of one tile with the products of another is the next step; it needs the
// shared memory of a second activation buffer, which 'high' does not have
// beside a weight ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kRows = 128;                  // fine voxels per tile
constexpr int kKc = 32;                     // weight rows per ring stage
constexpr int kStages = 2;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kMaxMid = 8;

// Phase timers, compiled in only with -DDECODE_TC_PHASES
// (tools/profile_decode_tc.py): SM cycles a consumer warpgroup spends per
// phase, summed over tiles and warpgroups.
enum Phase { kStaging, kUpsample, kPublish, kWaitWeights, kProducts,
             kEpilogue, kTile, kPhases };
#ifdef DECODE_TC_PHASES
__device__ unsigned long long g_phase_cycles[kPhases];
__device__ __forceinline__ long long phase_clock() { return clock64(); }
#else
__device__ __forceinline__ long long phase_clock() { return 0; }
#endif

struct Params {
  const float* z;
  int Dc, Hc, Wc, C1, S;
  const int* lo_d; const float* w_d;
  const int* lo_h; const float* w_h;
  const int* lo_w; const float* w_w;
  const float* aff0;     // [2][NP]        g0, s0 (zero-padded)
  const uint8_t* wts;    // [n_mid][NP/kKc][PARTS] chunk images (bf16)
  const float* epi;      // [n_mid][3][NP] b, g, s (zero-padded)
  const float* head;     // [NP + 3]       k (zero-padded), b, g, s
  float* out;            // [B][S][S][S]
  int n_mid, win, tiles_per_line;
  long long n_tiles;
};

__device__ __forceinline__ float affine_relu(float v, float g, float s) {
  return fmaxf(v, 0.0f) * g + s;
}

// The upsample and the first affine round each product and sum as the
// plain version's elementwise ops do (no FMA contraction), so the
// activations that are split into bf16 equal the plain version's bit for
// bit: at the bf16 tiers a one-ulp difference could flip a rounding.
__device__ __forceinline__ float lerp_rn(float w0, float a, float w1,
                                         float b) {
  return __fadd_rn(__fmul_rn(w0, a), __fmul_rn(w1, b));
}

__device__ __forceinline__ float affine_relu_rn(float v, float g, float s) {
  return __fadd_rn(__fmul_rn(fmaxf(v, 0.0f), g), s);
}

template <int NP, int PARTS>
__global__ void __launch_bounds__(kThreads, 1)
decode_tc_kernel(const Params p) {
  constexpr uint32_t kAPart = kRows * NP * 2;            // bytes, per part
  constexpr uint32_t kStagePart = kKc * NP * 2;
  constexpr uint32_t kStage = kStagePart * PARTS;
  constexpr int kLineStride = NP + 8;                   // floats
  constexpr int kChunks = NP / kKc;
  constexpr int kNR = NP / 2;                           // acc regs a thread

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* a_hi = smem;
  uint8_t* a_lo = smem + kAPart;
  uint8_t* ring = smem + kAPart * PARTS;
  float* line = reinterpret_cast<float*>(ring + kStage * kStages);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      line + static_cast<size_t>(p.win) * kLineStride);
  uint64_t* empty = full + kStages;

  const int t = threadIdx.x;
  // warpgroup index, warp-uniform for the compiler as well
  const int wg = __shfl_sync(0xffffffffu, t >> 7, 0);
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int S = p.S;
  if (wg == kConsumers / 128) {
    // ---- producer warp: weight chunks into the ring, tile after tile ----
    if (t == kConsumers && p.n_mid > 0) {
      uint32_t g = 0;
      const uint32_t per_tile = static_cast<uint32_t>(p.n_mid) * kChunks;
      for (long long tile = blockIdx.x; tile < p.n_tiles;
           tile += gridDim.x) {
        for (uint32_t c = 0; c < per_tile; ++c, ++g) {
          const int s = g % kStages;
          if (g >= kStages) mbar_wait(&empty[s], ((g / kStages) - 1) & 1);
          mbar_expect_tx(&full[s], kStage);
          bulk_g2s(ring + s * kStage,
                   p.wts + static_cast<size_t>(c) * kStage, kStage,
                   &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups of 64 rows each ----
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);
  const int lane = t & 31;
  const int qrow = lane >> 2;        // row within an 8-row group
  const int qcol = (lane & 3) * 2;   // column pair within a core matrix
  const int C1 = p.C1;
  const int64_t sw = C1;
  const int64_t sh = sw * p.Wc;
  const int64_t sd = sh * p.Hc;
  uint32_t g = 0;                    // weight chunks consumed so far
  long long cyc[kPhases] = {};

  for (long long tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const long long t_start = phase_clock();
    const int wt = static_cast<int>(tile % p.tiles_per_line);
    long long ln = tile / p.tiles_per_line;
    const int h = static_cast<int>(ln % S); ln /= S;
    const int d = static_cast<int>(ln % S);
    const long long b = ln / S;
    const int w0 = wt * kRows;
    const int nrows = min(kRows, S - w0);
    const int wbase = p.lo_w[w0];
    const int nw = min(p.win, p.Wc - wbase);

    bar_sync(1, kConsumers);   // the line buffer is free again

    // ---- D/H interpolation of the tile's window, exact f32 ----
    {
      const int dl = p.lo_d[d], hl = p.lo_h[h];
      const float wd0 = p.w_d[2 * d], wd1 = p.w_d[2 * d + 1];
      const float wh0 = p.w_h[2 * h], wh1 = p.w_h[2 * h + 1];
      const float* zb = p.z + (b * p.Dc + dl) * sd + hl * sh + wbase * sw;
      if ((C1 & 3) == 0) {
        const int c4 = C1 >> 2;
        for (int e = t; e < nw * c4; e += kConsumers) {
          const int j = e / c4, c = (e - j * c4) * 4;
          const float* q = zb + j * sw + c;
          const float4 p00 = *reinterpret_cast<const float4*>(q);
          const float4 p01 = *reinterpret_cast<const float4*>(q + sd);
          const float4 p10 = *reinterpret_cast<const float4*>(q + sh);
          const float4 p11 = *reinterpret_cast<const float4*>(q + sd + sh);
          float4 r;
          r.x = lerp_rn(wh0, lerp_rn(wd0, p00.x, wd1, p01.x),
                          wh1, lerp_rn(wd0, p10.x, wd1, p11.x));
          r.y = lerp_rn(wh0, lerp_rn(wd0, p00.y, wd1, p01.y),
                          wh1, lerp_rn(wd0, p10.y, wd1, p11.y));
          r.z = lerp_rn(wh0, lerp_rn(wd0, p00.z, wd1, p01.z),
                          wh1, lerp_rn(wd0, p10.z, wd1, p11.z));
          r.w = lerp_rn(wh0, lerp_rn(wd0, p00.w, wd1, p01.w),
                          wh1, lerp_rn(wd0, p10.w, wd1, p11.w));
          *reinterpret_cast<float4*>(line + j * kLineStride + c) = r;
        }
      } else {
        for (int e = t; e < nw * C1; e += kConsumers) {
          const int j = e / C1, c = e - j * C1;
          const float* q = zb + j * sw + c;
          line[j * kLineStride + c] =
              lerp_rn(wh0, lerp_rn(wd0, q[0], wd1, q[sd]),
                      wh1, lerp_rn(wd0, q[sh], wd1, q[sd + sh]));
        }
      }
    }
    bar_sync(1, kConsumers);
    long long t_mark = phase_clock();
    cyc[kStaging] += t_mark - t_start;

    // ---- W interpolation, relu*g0+s0, split into the A operand; with no
    // hidden layer the head runs here on the exact f32 activations ----
    for (int i = 0; i < 2; ++i) {
      const int m = (wg * 8 + (warp & 3) * 2 + i) * 8 + qrow;
      const bool valid = m < nrows;
      const int w = w0 + (valid ? m : 0);
      const float* l0 = line + (p.lo_w[w] - wbase) * kLineStride;
      const float* l1 = l0 + kLineStride;
      const float ww0 = p.w_w[2 * w], ww1 = p.w_w[2 * w + 1];
      float hsum = 0.0f;
#pragma unroll 4
      for (int kg = 0; kg < NP / 8; ++kg) {
        // line entries at k >= C1 are never written: computed, then
        // replaced by the exact zeros of the padded channels
        const int k = kg * 8 + qcol;
        const float2 x0 = *reinterpret_cast<const float2*>(l0 + k);
        const float2 x1 = *reinterpret_cast<const float2*>(l1 + k);
        const float2 g0 = *reinterpret_cast<const float2*>(p.aff0 + k);
        const float2 s0 = *reinterpret_cast<const float2*>(p.aff0 + NP + k);
        float v0 = affine_relu_rn(lerp_rn(ww0, x0.x, ww1, x1.x), g0.x, s0.x);
        float v1 = affine_relu_rn(lerp_rn(ww0, x0.y, ww1, x1.y), g0.y, s0.y);
        v0 = (valid && k < C1) ? v0 : 0.0f;
        v1 = (valid && k + 1 < C1) ? v1 : 0.0f;
        if (p.n_mid == 0)
          hsum += v0 * p.head[k] + v1 * p.head[k + 1];
        else
          store_split<PARTS>(a_hi, a_lo, core_offset(m, k, NP / 8), v0, v1);
      }
      if (p.n_mid == 0) {
        hsum += __shfl_xor_sync(0xffffffffu, hsum, 1);
        hsum += __shfl_xor_sync(0xffffffffu, hsum, 2);
        if (valid && (lane & 3) == 0)
          p.out[((b * S + d) * S + h) * S + w] =
              affine_relu(hsum + p.head[NP], p.head[NP + 1], p.head[NP + 2]);
      }
    }
    if (p.n_mid == 0) continue;
    cyc[kUpsample] += phase_clock() - t_mark;
    t_mark = phase_clock();
    fence_async_smem();
    bar_sync(2 + wg, 128);     // this warpgroup's A rows are written
    cyc[kPublish] += phase_clock() - t_mark;
    t_mark = phase_clock();

    // ---- hidden layers on the tensor cores ----
    const uint32_t a_base = smem_addr(a_hi) + wg * 8 * (NP / 8) * 128;
    const uint32_t ring_base = smem_addr(ring);
    for (int l = 0; l < p.n_mid; ++l) {
      float acc[kNR];
#pragma unroll
      for (int i = 0; i < kNR; ++i) acc[i] = 0.0f;
      fence_regs(acc);
      wgmma_fence();
      for (int c = 0; c < kChunks; ++c, ++g) {
        const int s = g % kStages;
        const long long t_wait = phase_clock();
        mbar_wait(&full[s], (g / kStages) & 1);
        cyc[kWaitWeights] += phase_clock() - t_wait;
#pragma unroll
        for (int ks = 0; ks < kKc / 16; ++ks) {
          const uint32_t ka = (c * (kKc / 16) + ks) * 256;
          const uint32_t kb = s * kStage + ks * 256;
          const uint64_t da_hi = make_desc(a_base + ka, 128, NP * 16);
          const uint64_t db_hi = make_desc(ring_base + kb, 128, 512);
          wgmma_ss<NP>(acc, da_hi, db_hi);
          if (PARTS == 2) {
            const uint64_t da_lo =
                make_desc(a_base + kAPart + ka, 128, NP * 16);
            const uint64_t db_lo =
                make_desc(ring_base + kb + kStagePart, 128, 512);
            wgmma_ss<NP>(acc, da_hi, db_lo);
            wgmma_ss<NP>(acc, da_lo, db_hi);
          }
        }
        wgmma_commit();
        if (c > 0) {
          wgmma_wait<1>();     // the previous chunk's products are done
          mbar_arrive_lane0(&empty[(g - 1) % kStages], lane);
        }
      }
      wgmma_wait<0>();
      fence_regs(acc);
      cyc[kProducts] += phase_clock() - t_mark;
      t_mark = phase_clock();
      mbar_arrive_lane0(&empty[(g - 1) % kStages], lane);
      bar_sync(2 + wg, 128);   // every warp's products have read A

      // epilogue: accumulator element i of this thread is row
      // 16*(warp%4) + qrow + 8*((i/2)%2), column 8*(i/4) + qcol + i%2
      const float* ep = p.epi + static_cast<size_t>(l) * 3 * NP;
      const int r0 = (warp & 3) * 16 + qrow;
      if (l + 1 < p.n_mid) {
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int col = j * 8 + qcol;
          const float2 bb = *reinterpret_cast<const float2*>(ep + col);
          const float2 gg = *reinterpret_cast<const float2*>(ep + NP + col);
          const float2 ss =
              *reinterpret_cast<const float2*>(ep + 2 * NP + col);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float v0 =
                affine_relu(acc[4 * j + 2 * hf] + bb.x, gg.x, ss.x);
            const float v1 =
                affine_relu(acc[4 * j + 2 * hf + 1] + bb.y, gg.y, ss.y);
            store_split<PARTS>(a_hi, a_lo,
                               core_offset(wg * 64 + r0 + 8 * hf, col, NP / 8),
                               v0, v1);
          }
        }
        fence_async_smem();
        bar_sync(2 + wg, 128);
      } else {
        float hs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < NP / 8; ++j) {
          const int col = j * 8 + qcol;
          const float2 bb = *reinterpret_cast<const float2*>(ep + col);
          const float2 gg = *reinterpret_cast<const float2*>(ep + NP + col);
          const float2 ss =
              *reinterpret_cast<const float2*>(ep + 2 * NP + col);
          const float2 kk = *reinterpret_cast<const float2*>(p.head + col);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            hs[hf] +=
                affine_relu(acc[4 * j + 2 * hf] + bb.x, gg.x, ss.x) * kk.x;
            hs[hf] +=
                affine_relu(acc[4 * j + 2 * hf + 1] + bb.y, gg.y, ss.y) * kk.y;
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          float v = hs[hf];
          v += __shfl_xor_sync(0xffffffffu, v, 1);
          v += __shfl_xor_sync(0xffffffffu, v, 2);
          const int m = wg * 64 + r0 + 8 * hf;
          if ((lane & 3) == 0 && m < nrows)
            p.out[((b * S + d) * S + h) * S + w0 + m] =
                affine_relu(v + p.head[NP], p.head[NP + 1], p.head[NP + 2]);
        }
      }
      cyc[kEpilogue] += phase_clock() - t_mark;
      t_mark = phase_clock();
    }
    cyc[kTile] += phase_clock() - t_start;
  }
#ifdef DECODE_TC_PHASES
  if ((t & 127) == 0)
    for (int i = 0; i < kPhases; ++i) atomicAdd(&g_phase_cycles[i], cyc[i]);
#endif
}

template <int NP, int PARTS>
int launch(const Params& p, size_t smem, void* stream) {
  auto kern = decode_tc_kernel<NP, PARTS>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long blocks = p.n_tiles < sms ? p.n_tiles : sms;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

#ifdef DECODE_TC_PHASES
// Copies the phase counters out (reset != 0: zeroes them instead).
extern "C" int dense_decode_tc_phases(unsigned long long* out, int reset) {
  if (reset) {
    const unsigned long long zero[kPhases] = {};
    return static_cast<int>(
        cudaMemcpyToSymbol(g_phase_cycles, zero, sizeof(zero)));
  }
  return static_cast<int>(cudaMemcpyFromSymbol(
      out, g_phase_cycles, sizeof(unsigned long long) * kPhases));
}
#endif

// Shared memory the kernel needs at padded width np, parts (1 or 2) and a
// line window of `win` coarse columns.
extern "C" long long dense_decode_tc_smem(int np, int parts, int win) {
  return static_cast<long long>(kRows) * np * 2 * parts +
         static_cast<long long>(kStages) * kKc * np * 2 * parts +
         static_cast<long long>(win) * (np + 8) * 4 + 2 * kStages * 8;
}

extern "C" int dense_decode_tc_launch(
    const float* z, int B, int Dc, int Hc, int Wc, int C1, int S,
    const int* lo_d, const float* w_d, const int* lo_h, const float* w_h,
    const int* lo_w, const float* w_w, const float* aff0,
    const void* wts, const float* epi, const float* head, int n_mid,
    int np, int parts, int win, float* out, void* stream) {
  if (n_mid < 0 || n_mid > kMaxMid || (parts != 1 && parts != 2) ||
      C1 < 1 || C1 > np || win < 2 || B < 1 || S < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.z = z; p.Dc = Dc; p.Hc = Hc; p.Wc = Wc; p.C1 = C1; p.S = S;
  p.lo_d = lo_d; p.w_d = w_d; p.lo_h = lo_h; p.w_h = w_h;
  p.lo_w = lo_w; p.w_w = w_w; p.aff0 = aff0;
  p.wts = static_cast<const uint8_t*>(wts); p.epi = epi; p.head = head;
  p.out = out; p.n_mid = n_mid; p.win = win;
  p.tiles_per_line = (S + kRows - 1) / kRows;
  p.n_tiles = static_cast<long long>(B) * S * S * p.tiles_per_line;
  const size_t smem = static_cast<size_t>(dense_decode_tc_smem(np, parts, win));
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  switch (np * 4 + parts) {
    case 64 * 4 + 1: return launch<64, 1>(p, smem, stream);
    case 64 * 4 + 2: return launch<64, 2>(p, smem, stream);
    case 128 * 4 + 1: return launch<128, 1>(p, smem, stream);
    case 128 * 4 + 2: return launch<128, 2>(p, smem, stream);
    case 256 * 4 + 1: return launch<256, 1>(p, smem, stream);
    case 256 * 4 + 2: return launch<256, 2>(p, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
