// Fused dense-lattice decode on Hopper's tensor cores (wgmma), at the JAX
// engine's three precision tiers.
//
// Replaces the TPU kernel garmentnets_tpu/ops/dense_decode_pallas.py:123
// (decode_tiles_pallas, driven by dense_decode_fused) at precision HIGHEST
// (bf16x6, f32-accurate), HIGH (bf16x3, `_mm`) and DEFAULT (one bf16
// pass). For each fine voxel (b, d, h, w) of the S^3 lattice
//   a   = relu(trilinear(z)[b, d, h, w, :]) * g0 + s0     exact f32
//   a   = relu(a @ K_l + b_l) * g_l + s_l                  each hidden layer
//   out = relu(a . k_head + b_head) * g_head + s_head      f32, CUDA cores
// with z = fv @ K0 + b0 computed outside. The hidden products run on
// wgmma.mma_async (m64 x N x k16, bf16 in, f32 accumulate), on operands
// split into PARTS bf16 parts, x_0 = bf16(x), x_p = bf16(x - x_0 - ...
// - x_{p-1}), each rounded to nearest even (the subtractions are exact):
//   PARTS 3 ('highest'): the six products of order 1, 2^-8 and 2^-16,
//       a0.W0 + a0.W1 + a1.W0 + a0.W2 + a1.W1 + a2.W0; the dropped terms
//       are of order 2^-24, f32's own rounding (the TPU's f32 product at
//       HIGHEST makes the same six passes)
//   PARTS 2 ('high'):    a_hi.W_hi + a_hi.W_lo + a_lo.W_hi   (as `_mm`)
//   PARTS 1 ('default'): a_hi.W_hi
// Where JAX differs: its kernel also sends the W-axis upsample through
// `_mm`; here the whole upsample is exact f32, so at least as accurate.
//
// Bound (B=8, 128^3, 128-256-256-1): one 256x256 product per voxel is
// 2.2 TFLOP per batch: 13.34 ms at bf16x6 (six passes at 989 TFLOP/s),
// 6.67 ms at bf16x3 and 2.22 ms at one pass; the f32 upsample, affines,
// splits and head are ~0.06 TFLOP on the CUDA cores (~0.9 ms at 67
// TFLOP/s, can overlap); bytes are 0.34 GB (0.1 ms). Tensor-core
// operations bound it.
//
// Design:
// - The products go to the tensor cores through wgmma, the only route to
//   their full rate; wgmma reads both operands from shared memory (SS form)
//   in 128-byte core matrices, so no register tiling through shared memory
//   is left on the product's path.
// - A persistent block per SM owns tiles of consecutive voxels of one
//   W-line and a producer warp keeps the next weight chunks in flight
//   across tile boundaries, so the upsample and epilogue of one tile
//   overlap the loads of the next. The weights stream through a 2-stage
//   ring of 32-row K-chunks: one cp.async.bulk per chunk (no tensor map)
//   into an mbarrier. The wrapper packs each chunk
//   (kernels/dense_decode_tc.pack_wgmma_weights) into the exact
//   shared-memory image of the wgmma B operand: K-major, no swizzle, 8x8
//   core matrices of 128 contiguous bytes (LBO 128 B along K, SBO 512 B
//   along N). The activations (A operand, one buffer per part) live in
//   shared memory in the same core-matrix layout (LBO 128 B, SBO NP*16 B):
//   the accumulator fragment of a layer maps onto whole core-matrix rows,
//   so the epilogue's bf16x2 stores and wgmma's reads are both free of bank
//   conflicts.
// - Tile shapes. 128-row tiles (ROWS 128) give each of the two consumer
//   warpgroups 64 rows and all NP columns (NP/2 accumulator registers a
//   thread). At bf16x6 and NP = 256 the three A parts of 128 rows (192 KB)
//   and a 3-part ring stage (48 KB) do not fit in 227 KB, so that instance
//   takes 64-row tiles (ROWS 64): both warpgroups read the same 64 rows of
//   A and split N, 128 columns (64 registers a thread) each. Shared memory
//   there: 96 KB A + 96 KB ring + ~18 KB line buffer. A 64-row tile reads
//   all of a layer's weights (384 KB at NP = 256 in three parts) for half
//   the rows of a 128-row tile, ~100 GB of L2 reads per batch. Sharing the
//   ring stages over a 2-block cluster (multicast bulk copies) halved those
//   reads but measured slower on the H100 (PERF.md), so each block streams
//   its own weights.
// - Upsample: the D/H interpolation is done once per tile into a
//   [window, C1] f32 line buffer, then each row W-interpolates from it,
//   with the plain version's roundings. A thread issues the loads of eight
//   column groups before their stores into A: both live in shared memory,
//   so the compiler may not move a load above an earlier store, and one
//   load, one store at a time left the upsample latency-bound. Tiles go in
//   (b, d, h, w) order, so the blocks in flight share coarse rows in L2.
//   Widths are zero-padded by the wrapper to NP in {64, 128, 256}; padded
//   channels carry exact zeros.
// - Strips: a launch decodes the D planes d_begin .. d_begin + d_count - 1
//   into a [B, d_count, S, S] output (ops/dense_decode.dense_decode_sharded
//   gives each device of a mesh's "space" axis one strip). The axis plans
//   stay over the whole S and each voxel's arithmetic is the same, so a
//   strip equals that slice of the whole volume bit for bit.
//
// Where the time goes (tools/profile_decode_tc.py; PERF.md): the phases of
// a tile run one after another, so the tensor cores wait while the CUDA
// cores stage, upsample and split and run the epilogue (~45% of the time
// at 'highest', ~60% at 'high'); the products run near the tensor cores'
// rate between waits on the 2-stage weight ring (~20%). Overlapping the
// CUDA-core phases of one tile with the products of another is the next
// step; it needs the shared memory of a second activation buffer, which no
// tier has beside its weight ring.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

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
  float* out;            // [B][d_count][S][S]
  int d_begin, d_count;  // the strip of D planes this launch decodes
  int n_mid, win, tiles_per_line;
  long long n_tiles;
};

// Fine voxels per tile: 64 only where three A parts of 128 rows and a ring
// would not fit (bf16x6 at NP = 256).
__host__ __device__ constexpr int tile_rows(int np, int parts) {
  return parts == 3 && np == 256 ? 64 : 128;
}

// The A operand element (row, k), split into PARTS bf16 parts at the
// part buffers a, a + part, a + 2 part.
template <int PARTS>
__device__ __forceinline__ void store_parts(uint8_t* a, uint32_t part,
                                            uint32_t off, float v0,
                                            float v1) {
  if constexpr (PARTS == 3)
    store_split3(a, a + part, a + 2 * part, off, v0, v1);
  else
    store_split<PARTS>(a, a + part, off, v0, v1);
}

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

template <int NP, int PARTS, int ROWS>
__global__ void __launch_bounds__(kThreads, 1)
decode_tc_kernel(const Params p) {
  constexpr bool kSplitN = ROWS == 64;   // warpgroups split N, not M
  constexpr int kNW = kSplitN ? NP / 2 : NP;             // columns a wg
  constexpr uint32_t kAPart = ROWS * NP * 2;             // bytes, per part
  constexpr uint32_t kStagePart = kKc * NP * 2;
  constexpr uint32_t kStage = kStagePart * PARTS;
  constexpr int kLineStride = NP + 8;                   // floats
  constexpr int kChunks = NP / kKc;
  constexpr int kNR = kNW / 2;                          // acc regs a thread
  constexpr int kRowIters = ROWS / 64;                  // upsample passes

  extern __shared__ __align__(128) uint8_t smem[];
  uint8_t* ring = smem + kAPart * PARTS;
  float* line = reinterpret_cast<float*>(ring + kStage * kStages);
  uint64_t* full = reinterpret_cast<uint64_t*>(
      line + static_cast<size_t>(p.win) * kLineStride);
  uint64_t* empty = full + kStages;
  float* head_part = reinterpret_cast<float*>(empty + kStages);  // [64]

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

  // ---- consumers: two warpgroups, 64 rows each (ROWS 128) or the same 64
  // rows and half of the columns each (ROWS 64) ----
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);
  const int lane = t & 31;
  const int qrow = lane >> 2;        // row within an 8-row group
  const int qcol = (lane & 3) * 2;   // column pair within a core matrix
  const int C1 = p.C1;
  const int64_t sw = C1;
  const int64_t sh = sw * p.Wc;
  const int64_t sd = sh * p.Hc;
  const int bar_wg = kSplitN ? 2 : 2 + wg;         // A's readers
  const int bar_n = kSplitN ? kConsumers : 128;
  uint32_t g = 0;                    // weight chunks consumed so far
  long long cyc[kPhases] = {};

  for (long long tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const long long t_start = phase_clock();
    const int wt = static_cast<int>(tile % p.tiles_per_line);
    long long ln = tile / p.tiles_per_line;
    const int h = static_cast<int>(ln % S); ln /= S;
    const int dd = static_cast<int>(ln % p.d_count);   // plane in the strip
    const int d = p.d_begin + dd;
    const long long b = ln / p.d_count;
    // the strip's output row of this line: [B][d_count][S][S]
    float* const out_line = p.out + ((b * p.d_count + dd) * S + h) * S;
    const int w0 = wt * ROWS;
    const int nrows = min(ROWS, S - w0);
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
          const float4 p11 =
              *reinterpret_cast<const float4*>(q + sd + sh);
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

    // ---- W interpolation, relu*g0+s0, split into the A operand; with
    // no hidden layer the head runs here on the exact f32 activations ----
    for (int i = 0; i < kRowIters; ++i) {
      const int m = (warp * kRowIters + i) * 8 + qrow;
      const bool valid = m < nrows;
      const int w = w0 + (valid ? m : 0);
      const float* l0 = line + (p.lo_w[w] - wbase) * kLineStride;
      const float* l1 = l0 + kLineStride;
      const float ww0 = p.w_w[2 * w], ww1 = p.w_w[2 * w + 1];
      float hsum = 0.0f;
      // the loads of kB column groups go out before any of their stores:
      // A and the line buffer share the shared-memory space, so the
      // compiler may not move a line load above an earlier A store
      constexpr int kB = 8;
#pragma unroll 1
      for (int kg0 = 0; kg0 < NP / 8; kg0 += kB) {
        float2 x0[kB], x1[kB], g0[kB], s0[kB];
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          const int k = (kg0 + u) * 8 + qcol;
          x0[u] = *reinterpret_cast<const float2*>(l0 + k);
          x1[u] = *reinterpret_cast<const float2*>(l1 + k);
          g0[u] = __ldg(reinterpret_cast<const float2*>(p.aff0 + k));
          s0[u] = __ldg(reinterpret_cast<const float2*>(p.aff0 + NP + k));
        }
#pragma unroll
        for (int u = 0; u < kB; ++u) {
          // line entries at k >= C1 are never written: computed, then
          // replaced by the exact zeros of the padded channels
          const int k = (kg0 + u) * 8 + qcol;
          float v0 = affine_relu_rn(lerp_rn(ww0, x0[u].x, ww1, x1[u].x),
                                    g0[u].x, s0[u].x);
          float v1 = affine_relu_rn(lerp_rn(ww0, x0[u].y, ww1, x1[u].y),
                                    g0[u].y, s0[u].y);
          v0 = (valid && k < C1) ? v0 : 0.0f;
          v1 = (valid && k + 1 < C1) ? v1 : 0.0f;
          if (p.n_mid == 0)
            hsum += v0 * p.head[k] + v1 * p.head[k + 1];
          else
            store_parts<PARTS>(smem, kAPart, core_offset(m, k, NP / 8),
                               v0, v1);
        }
      }
      if (p.n_mid == 0) {
        hsum += __shfl_xor_sync(0xffffffffu, hsum, 1);
        hsum += __shfl_xor_sync(0xffffffffu, hsum, 2);
        if (valid && (lane & 3) == 0)
          out_line[w] = affine_relu(
              hsum + p.head[NP], p.head[NP + 1], p.head[NP + 2]);
      }
    }
    if (p.n_mid == 0) continue;
    cyc[kUpsample] += phase_clock() - t_mark;
    t_mark = phase_clock();
    fence_async_smem();
    bar_sync(bar_wg, bar_n);   // the A rows this warpgroup reads are written
    cyc[kPublish] += phase_clock() - t_mark;
    t_mark = phase_clock();

    // ---- hidden layers on the tensor cores ----
    const uint32_t a_base =
        smem_addr(smem) + (kSplitN ? 0 : wg * 8 * (NP / 8) * 128);
    // this warpgroup's columns: 8-column groups of B are 512 B apart
    const uint32_t ring_base =
        smem_addr(ring) + (kSplitN ? wg * (kNW / 8) * 512 : 0);
    const int row_base = kSplitN ? 0 : wg * 64;
    const int col_base = kSplitN ? wg * kNW : 0;
    for (int l = 0; l < p.n_mid; ++l) {
      // bf16x6 keeps its five small products (orders 2^-8 and 2^-16) in
      // a second accumulator, added to the hi.hi sum at the end, so their
      // sum does not take the rounding of the large one at every step
      float acc[kNR], cor[PARTS == 3 ? kNR : 1];
#pragma unroll
      for (int i = 0; i < kNR; ++i) acc[i] = 0.0f;
#pragma unroll
      for (int i = 0; i < (PARTS == 3 ? kNR : 1); ++i) cor[i] = 0.0f;
      fence_regs(acc);
      fence_regs(cor);
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
          uint64_t da[PARTS], db[PARTS];
#pragma unroll
          for (int q = 0; q < PARTS; ++q) {
            da[q] = make_desc(a_base + q * kAPart + ka, 128, NP * 16);
            db[q] = make_desc(ring_base + kb + q * kStagePart, 128, 512);
          }
          // orders 1, 2^-8 (and 2^-16): a0.W0, a0.W1, a1.W0, a0.W2,
          // a1.W1, a2.W0
          wgmma_ss<kNW>(acc, da[0], db[0]);
          if constexpr (PARTS == 2) {
            wgmma_ss<kNW>(acc, da[0], db[1]);
            wgmma_ss<kNW>(acc, da[1], db[0]);
          }
          if constexpr (PARTS == 3) {
            wgmma_ss<kNW>(cor, da[0], db[1]);
            wgmma_ss<kNW>(cor, da[1], db[0]);
            wgmma_ss<kNW>(cor, da[0], db[2]);
            wgmma_ss<kNW>(cor, da[1], db[1]);
            wgmma_ss<kNW>(cor, da[2], db[0]);
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
      fence_regs(cor);
      if constexpr (PARTS == 3) {
#pragma unroll
        for (int i = 0; i < kNR; ++i) acc[i] += cor[i];
      }
      cyc[kProducts] += phase_clock() - t_mark;
      t_mark = phase_clock();
      mbar_arrive_lane0(&empty[(g - 1) % kStages], lane);
      bar_sync(bar_wg, bar_n);   // every warp's products have read A

      // epilogue: accumulator element i of this thread is row
      // 16*(warp%4) + qrow + 8*((i/2)%2), column 8*(i/4) + qcol + i%2 of
      // this warpgroup's rows and columns
      const float* ep = p.epi + static_cast<size_t>(l) * 3 * NP;
      const int r0 = row_base + (warp & 3) * 16 + qrow;
      if (l + 1 < p.n_mid) {
#pragma unroll
        for (int j = 0; j < kNW / 8; ++j) {
          const int col = col_base + j * 8 + qcol;
          const float2 bb = *reinterpret_cast<const float2*>(ep + col);
          const float2 gg =
              *reinterpret_cast<const float2*>(ep + NP + col);
          const float2 ss =
              *reinterpret_cast<const float2*>(ep + 2 * NP + col);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const float v0 =
                affine_relu(acc[4 * j + 2 * hf] + bb.x, gg.x, ss.x);
            const float v1 =
                affine_relu(acc[4 * j + 2 * hf + 1] + bb.y, gg.y, ss.y);
            store_parts<PARTS>(smem, kAPart,
                               core_offset(r0 + 8 * hf, col, NP / 8), v0,
                               v1);
          }
        }
        fence_async_smem();
        bar_sync(bar_wg, bar_n);
      } else {
        float hs[2] = {0.0f, 0.0f};
#pragma unroll
        for (int j = 0; j < kNW / 8; ++j) {
          const int col = col_base + j * 8 + qcol;
          const float2 bb = *reinterpret_cast<const float2*>(ep + col);
          const float2 gg =
              *reinterpret_cast<const float2*>(ep + NP + col);
          const float2 ss =
              *reinterpret_cast<const float2*>(ep + 2 * NP + col);
          const float2 kk = *reinterpret_cast<const float2*>(p.head + col);
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            hs[hf] +=
                affine_relu(acc[4 * j + 2 * hf] + bb.x, gg.x, ss.x) * kk.x;
            hs[hf] += affine_relu(acc[4 * j + 2 * hf + 1] + bb.y, gg.y,
                                  ss.y) * kk.y;
          }
        }
#pragma unroll
        for (int hf = 0; hf < 2; ++hf) {
          hs[hf] += __shfl_xor_sync(0xffffffffu, hs[hf], 1);
          hs[hf] += __shfl_xor_sync(0xffffffffu, hs[hf], 2);
        }
        if (kSplitN) {
          // the second warpgroup hands its half of each row's dot
          // product to the first
          if (wg == 1 && (lane & 3) == 0) {
            head_part[r0] = hs[0];
            head_part[r0 + 8] = hs[1];
          }
          bar_sync(bar_wg, bar_n);
        }
        if (!kSplitN || wg == 0) {
#pragma unroll
          for (int hf = 0; hf < 2; ++hf) {
            const int m = r0 + 8 * hf;
            const float v = kSplitN ? hs[hf] + head_part[m] : hs[hf];
            if ((lane & 3) == 0 && m < nrows)
              out_line[w0 + m] = affine_relu(
                  v + p.head[NP], p.head[NP + 1], p.head[NP + 2]);
          }
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
int launch(const Params& p0, size_t smem, void* stream) {
  constexpr int kR = tile_rows(NP, PARTS);
  auto kern = decode_tc_kernel<NP, PARTS, kR>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  Params p = p0;
  p.tiles_per_line = (p.S + kR - 1) / kR;
  p.n_tiles *= p.tiles_per_line;
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

// Fine voxels per tile of the instance at padded width np and parts; the
// wrapper sizes the line window by it.
extern "C" int dense_decode_tc_tile_rows(int np, int parts) {
  return tile_rows(np, parts);
}

// Shared memory the kernel needs at padded width np, parts (1, 2 or 3) and
// a line window of `win` coarse columns.
extern "C" long long dense_decode_tc_smem(int np, int parts, int win) {
  const long long rows = tile_rows(np, parts);
  return rows * np * 2 * parts +
         static_cast<long long>(kStages) * kKc * np * 2 * parts +
         static_cast<long long>(win) * (np + 8) * 4 + 2 * kStages * 8 +
         (rows == 64 ? 64 * 4 : 0);
}

extern "C" int dense_decode_tc_launch(
    const float* z, int B, int Dc, int Hc, int Wc, int C1, int S,
    int d_begin, int d_count, const int* lo_d, const float* w_d,
    const int* lo_h, const float* w_h,
    const int* lo_w, const float* w_w, const float* aff0,
    const void* wts, const float* epi, const float* head, int n_mid,
    int np, int parts, int win, float* out, void* stream) {
  if (n_mid < 0 || n_mid > kMaxMid || parts < 1 || parts > 3 ||
      C1 < 1 || C1 > np || win < 2 || B < 1 || S < 1 || d_begin < 0 ||
      d_count < 1 || d_begin + d_count > S)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.z = z; p.Dc = Dc; p.Hc = Hc; p.Wc = Wc; p.C1 = C1; p.S = S;
  p.lo_d = lo_d; p.w_d = w_d; p.lo_h = lo_h; p.w_h = w_h;
  p.lo_w = lo_w; p.w_w = w_w; p.aff0 = aff0;
  p.wts = static_cast<const uint8_t*>(wts); p.epi = epi; p.head = head;
  p.out = out; p.n_mid = n_mid; p.win = win;
  p.d_begin = d_begin; p.d_count = d_count;
  // lines (b, d, h) of the strip; launch() tiles them
  p.n_tiles = static_cast<long long>(B) * d_count * S;
  const size_t smem = static_cast<size_t>(dense_decode_tc_smem(np, parts, win));
  if (smem > 232448) return static_cast<int>(cudaErrorInvalidValue);
  switch (np * 4 + parts) {
    case 64 * 4 + 1: return launch<64, 1>(p, smem, stream);
    case 64 * 4 + 2: return launch<64, 2>(p, smem, stream);
    case 64 * 4 + 3: return launch<64, 3>(p, smem, stream);
    case 128 * 4 + 1: return launch<128, 1>(p, smem, stream);
    case 128 * 4 + 2: return launch<128, 2>(p, smem, stream);
    case 128 * 4 + 3: return launch<128, 3>(p, smem, stream);
    case 256 * 4 + 1: return launch<256, 1>(p, smem, stream);
    case 256 * 4 + 2: return launch<256, 2>(p, smem, stream);
    case 256 * 4 + 3: return launch<256, 3>(p, smem, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
