// Fused eval-mode set abstraction on Hopper's tensor cores (wgmma, bf16x3):
// neighbour gather + BN-folded MLP chain + masked max over the slots.
//
// Replaces the TPU kernel garmentnets_tpu/kernels/sa_pallas.py:166
// (sa_fused, kernel body _sa_kernel) at its "bf16_3x" products (`_mm`).
//
// For batch row b, center m and neighbour slot k, with j = idx[b, m, k]:
//   h = concat(x[b, j], pos[b, j] - centers[b, m])
//   h = relu(h @ K_l + b_l) * g_l + s_l           for each layer l
//   out[b, m] = max over the slots k with mask[b, m, k] of h
// A center with no valid slot gives -inf, as the plain version does. Each
// product h @ K runs as a_hi.W_hi + a_hi.W_lo + a_lo.W_hi on
// wgmma.mma_async (bf16 in, f32 accumulate), x_hi = bf16(x) and x_lo =
// bf16(x - f32(x_hi)), round to nearest even: the plain version's 'high'
// tier (ops/set_abstraction.sa_fused_plain(precision="high")).
//
// What bounds it: the products, on paper. At B=8, K=64 the two stage-1
// calls do 38.9 and 50.6 GFLOP of products over all slots, three passes
// each at 989 TFLOP/s (~0.27 ms); the gather, splits and epilogues are a
// few GFLOP on the CUDA cores; the bytes (~50 MB) take ~15 us. In practice
// the CUDA-core phases (gather, epilogues, the max) run in series with the
// products inside each warpgroup, and they, not the tensor cores, set the
// pace: a build without the products kept most of the kernel's time.
//
// Design:
// - Persistent blocks walk over 128-row tiles: a tile is 128 / Kp
//   centers' Kp slots (two centers at Kp = 64). Each of two consumer
//   warpgroups owns 64 rows of the tile: it gathers them, runs their
//   products and epilogues, and takes their max, with barriers of its own
//   only, so one warpgroup's CUDA-core work overlaps another's products.
//   Two blocks share an SM (<= 113 registers a thread, <= 113 KB of shared
//   memory each), so four warpgroups hide each other's latencies.
// - The MLP runs as passes of at most 128 output columns (64 accumulator
//   registers a thread): one per hidden layer (width <= 128), and the last
//   layer's columns in passes of 128 (two at SA2's 256) that read the same
//   A operand and each fold their own columns' max.
// - The gather happens inside the kernel: for each row, x[b, j] and
//   pos[b, j] - centers[b, m] in f32 (L2-resident inputs), split into bf16
//   hi and lo in shared memory in the no-swizzle K-major core-matrix layout
//   of the wgmma A operand (wgmma_common.cuh core_offset). A thread writes
//   one core-matrix row (8 columns, two float4 loads where they lie in x;
//   16 bytes of hi and of lo); eight threads fill one 8x8 core matrix.
//   Invalid slots get zero rows and are left out of the max. The first
//   layer's input width Cin + 3 is zero-padded to a multiple of 16 (6 -> 16
//   at SA1, 131 -> 144 at SA2).
// - Each pass is 64 x N x 16 wgmmas (N = 64 or 128) per warpgroup, A and B
//   from shared memory. A hidden pass's epilogue applies bias, ReLU and the
//   affine in f32 and writes the next layer's hi/lo A operand in place
//   (after the warpgroup's products have read it). A last-layer pass folds
//   the masked max over each center's slots into registers (two rows a
//   thread, then shuffles over the 8 rows of a quad column) and one small
//   shared-memory pass over the warps.
// - Weights, split into bf16 hi and lo by the wrapper and packed as 16-row
//   K-chunks in the B operand's shared-memory image
//   (kernels/dense_decode_tc.pack_wgmma_weights with kc = 16):
//   * resident when they fit beside the activations: SA1's 53 KB are
//     loaded once per block with bulk copies, not once per 64 rows;
//   * streamed otherwise: SA2's 264 KB cannot sit beside its 72 KB of
//     activations, so a producer warp streams the chunks, tile after tile,
//     through a ring of 8 KB stages (cp.async.bulk into mbarriers, as
//     csrc/dense_decode_tc.cu does; four stages, so that two blocks still
//     fit on an SM, measured as fast as eight). That reads SA2's weights
//     once per 128 rows from L2 (~0.8 GB per batch, against ~1.6 GB of f32
//     for the earlier f32 kernel). Chosen over splitting the last layer's
//     columns across a 2-block cluster because the first two layers alone
//     (136 KB as hi + lo) do not fit beside the activations either, so a
//     cluster would have to split every layer and exchange the activations
//     between its blocks.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math_constants.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kRows = 128;                  // neighbour rows per tile
constexpr int kWgRows = 64;                 // rows of one warpgroup
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr int kMaxPasses = 5;
constexpr int kMaxStages = 8;
constexpr int kKStep = 16;                  // K rows per weight chunk
constexpr int kMaxNP = 128;                 // widest pass
constexpr int kCopy = 16384;                // bytes per resident bulk copy
constexpr int kBarBytes = 256;              // mbarriers at the front
constexpr long long kMaxSmem = 232448;

struct Params {
  const float* x;          // [B][N][Cin]
  const float* pos;        // [B][N][3]
  const float* centers;    // [B][M][3]
  const long long* idx;    // [B][M][Kp]
  const unsigned char* mask;
  float* out;              // [B][M][cout_last]
  const uint8_t* wts;      // per pass [kp/16][hi, lo][np * 16] bf16
  const float* epi;        // per pass [3][np] b, g, s (zero-padded)
  long long n_rows;        // B * M * Kp
  long long n_tiles;
  int N, M, Cin, Kp;
  int n_passes, n_hidden;  // passes; the first n_hidden are hidden layers
  int kp[kMaxPasses];      // padded input width (multiple of 16)
  int np[kMaxPasses];      // padded output width (64 or 128)
  int col0[kMaxPasses];    // first output column of a last-layer pass
  int w_off[kMaxPasses];   // byte offset of the pass's chunks in wts
  int e_off[kMaxPasses];   // float offset of the pass's b, g, s in epi
  int kp_max, cout_last;
  int n_stages;            // 0: resident weights; else ring stages
  int stage_bytes;         // ring stage: the largest chunk
  int w_bytes;             // all passes' chunks
};

// bias, ReLU and affine
__device__ __forceinline__ float act(float v, float b, float g, float s) {
  return fmaxf(v + b, 0.0f) * g + s;
}

// Element c of a row's layer-0 input: x[b, j, c], then pos[b, j] -
// centers[b, m], then zeros. pt = b * N + j, gc = b * M + m.
__device__ __forceinline__ float input_value(const Params& p, int pt, int gc,
                                             int c) {
  if (c < p.Cin) return __ldg(p.x + static_cast<int64_t>(pt) * p.Cin + c);
  const int d = c - p.Cin;
  if (d < 3)
    return __fsub_rn(__ldg(p.pos + static_cast<int64_t>(pt) * 3 + d),
                     __ldg(p.centers + static_cast<int64_t>(gc) * 3 + d));
  return 0.0f;
}

// Split 8 f32 values (one core-matrix row) into bf16 hi and lo and store
// each as 16 bytes.
__device__ __forceinline__ void store_split8(uint8_t* a_hi, uint8_t* a_lo,
                                             uint32_t off, const float* v) {
  uint4 hi, lo;
  uint32_t* h = reinterpret_cast<uint32_t*>(&hi);
  uint32_t* l = reinterpret_cast<uint32_t*>(&lo);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const __nv_bfloat162 hh = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
    const float2 back = __bfloat1622float2(hh);
    const __nv_bfloat162 ll =
        __floats2bfloat162_rn(v[2 * i] - back.x, v[2 * i + 1] - back.y);
    h[i] = *reinterpret_cast<const uint32_t*>(&hh);
    l[i] = *reinterpret_cast<const uint32_t*>(&ll);
  }
  *reinterpret_cast<uint4*>(a_hi + off) = hi;
  *reinterpret_cast<uint4*>(a_lo + off) = lo;
}

// One pass on a warpgroup's 64 rows: A (hi, lo) in its shared-memory
// region, the weights resident or from the ring; then either the next
// layer's A (a hidden layer) or the masked max of each center over this
// pass's output columns (a pass of the last layer).
template <int NP, bool kRing>
__device__ __forceinline__ void sa_pass(
    const Params& p, int i, uint8_t* a_hi, uint8_t* a_lo, uint8_t* w,
    uint64_t* full, uint64_t* empty, uint32_t& g, float* red,
    const int* s_gc, const int* s_valid, long long row0, int bar, int wq,
    int lane, int tw) {
  constexpr int kNR = NP / 2;                    // accumulators a thread
  constexpr uint32_t kPart = NP * kKStep * 2;    // bytes of a chunk's part
  const int kp = p.kp[i];
  const uint32_t sbo_a = static_cast<uint32_t>(kp) * 16;
  const uint32_t a_hi_s = smem_addr(a_hi), a_lo_s = smem_addr(a_lo);
  const uint32_t w_s = smem_addr(w);

  float acc[kNR];
#pragma unroll
  for (int r = 0; r < kNR; ++r) acc[r] = 0.0f;
  fence_regs(acc);
  wgmma_fence();
  for (int c = 0; c < kp / kKStep; ++c) {
    uint32_t wb;
    if (kRing) {
      const int s = g % p.n_stages;
      mbar_wait(&full[s], (g / p.n_stages) & 1);
      wb = w_s + s * p.stage_bytes;
    } else {
      wb = w_s + p.w_off[i] + c * 2 * kPart;
    }
    const uint64_t da_hi = make_desc(a_hi_s + c * 256, 128, sbo_a);
    const uint64_t da_lo = make_desc(a_lo_s + c * 256, 128, sbo_a);
    const uint64_t db_hi = make_desc(wb, 128, 256);
    const uint64_t db_lo = make_desc(wb + kPart, 128, 256);
    wgmma_ss<NP>(acc, da_hi, db_hi);
    wgmma_ss<NP>(acc, da_hi, db_lo);
    wgmma_ss<NP>(acc, da_lo, db_hi);
    wgmma_commit();
    if (kRing) {
      if (c > 0) {
        wgmma_wait<1>();     // the previous chunk's products are done
        mbar_arrive_lane0(&empty[(g - 1) % p.n_stages], lane);
      }
      ++g;
    }
  }
  wgmma_wait<0>();
  fence_regs(acc);
  if (kRing) mbar_arrive_lane0(&empty[(g - 1) % p.n_stages], lane);
  bar_sync(bar, 128);        // every warp's products have read A

  // accumulator element r of this thread is row 16 * wq + qrow +
  // 8 * ((r / 2) % 2), column 8 * (r / 4) + qcol + r % 2
  const float* ep = p.epi + p.e_off[i];
  const int qrow = lane >> 2;
  const int qcol = (lane & 3) * 2;
  const int r0 = wq * 16 + qrow;
  if (i < p.n_hidden) {
#pragma unroll
    for (int j = 0; j < NP / 8; ++j) {
      const int col = j * 8 + qcol;
      const float2 bb = __ldg(reinterpret_cast<const float2*>(ep + col));
      const float2 gg = __ldg(reinterpret_cast<const float2*>(ep + NP + col));
      const float2 ss =
          __ldg(reinterpret_cast<const float2*>(ep + 2 * NP + col));
#pragma unroll
      for (int hf = 0; hf < 2; ++hf)
        store_split<2>(a_hi, a_lo, core_offset(r0 + 8 * hf, col, NP / 8),
                       act(acc[4 * j + 2 * hf], bb.x, gg.x, ss.x),
                       act(acc[4 * j + 2 * hf + 1], bb.y, gg.y, ss.y));
    }
    fence_async_smem();
    bar_sync(bar, 128);      // the next layer's A is written
    return;
  }

  // a last-layer pass: the max over this thread's two rows, then over the
  // 8 rows of its quad column, then (below) over the warps of each center
  const bool ok0 = s_valid[r0] != 0, ok1 = s_valid[r0 + 8] != 0;
#pragma unroll
  for (int j = 0; j < NP / 8; ++j) {
    const int col = j * 8 + qcol;
    const float2 bb = __ldg(reinterpret_cast<const float2*>(ep + col));
    const float2 gg = __ldg(reinterpret_cast<const float2*>(ep + NP + col));
    const float2 ss = __ldg(reinterpret_cast<const float2*>(ep + 2 * NP + col));
    float mx[2];
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const float b = e ? bb.y : bb.x, gm = e ? gg.y : gg.x,
                  s = e ? ss.y : ss.x;
      const float v0 = ok0 ? act(acc[4 * j + e], b, gm, s) : -CUDART_INF_F;
      const float v1 = ok1 ? act(acc[4 * j + 2 + e], b, gm, s) : -CUDART_INF_F;
      float v = fmaxf(v0, v1);
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 4));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 8));
      v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, 16));
      mx[e] = v;
    }
    if (qrow == 0)
      *reinterpret_cast<float2*>(red + wq * NP + col) =
          make_float2(mx[0], mx[1]);
  }
  bar_sync(bar, 128);
  const int centers = kWgRows / p.Kp;            // per warpgroup
  const int warps = p.Kp / 16;                   // per center
  const int cols = min(NP, p.cout_last - p.col0[i]);
  for (int e = tw; e < centers * cols; e += 128) {
    const int c = e / cols, col = e - c * cols;
    float v = red[c * warps * NP + col];
    for (int q = 1; q < warps; ++q) v = fmaxf(v, red[(c * warps + q) * NP + col]);
    if (row0 + c * p.Kp < p.n_rows)
      p.out[static_cast<int64_t>(s_gc[c * p.Kp]) * p.cout_last + p.col0[i] +
            col] = v;
  }
  bar_sync(bar, 128);        // red and the row tables are free again
}

template <bool kRing>
__global__ void __launch_bounds__(kThreads, 2) sa_tc_kernel(const Params p) {
  extern __shared__ __align__(128) uint8_t smem[];
  uint64_t* full = reinterpret_cast<uint64_t*>(smem);
  uint64_t* empty = full + kMaxStages;
  const uint32_t a_part = kWgRows * p.kp_max * 2;   // one part, one group
  uint8_t* a = smem + kBarBytes;
  uint8_t* w = a + 4 * a_part;
  const int w_region = kRing ? p.n_stages * p.stage_bytes : p.w_bytes;
  float* red = reinterpret_cast<float*>(w + w_region);
  int* s_pt = reinterpret_cast<int*>(red + 8 * kMaxNP);
  int* s_gc = s_pt + kRows;
  int* s_valid = s_gc + kRows;

  const int t = threadIdx.x;
  // warpgroup index, warp-uniform for the compiler as well
  const int wg = __shfl_sync(0xffffffffu, t >> 7, 0);
  if (t == 0) {
    for (int s = 0; s < kMaxStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (wg == kConsumers / 128) {
    // ---- producer warp: the weights, once or chunk after chunk ----
    if (t == kConsumers) {
      if (!kRing) {
        mbar_expect_tx(&full[0], p.w_bytes);
        for (int off = 0; off < p.w_bytes; off += kCopy)
          bulk_g2s(w + off, p.wts + off, min(kCopy, p.w_bytes - off),
                   &full[0]);
      } else {
        uint32_t g = 0;
        for (long long tile = blockIdx.x; tile < p.n_tiles;
             tile += gridDim.x) {
          for (int i = 0; i < p.n_passes; ++i) {
            const uint32_t cb = p.np[i] * kKStep * 4;   // hi + lo
            for (int c = 0; c < p.kp[i] / kKStep; ++c, ++g) {
              const int s = g % p.n_stages;
              if (g >= static_cast<uint32_t>(p.n_stages))
                mbar_wait(&empty[s], ((g / p.n_stages) - 1) & 1);
              mbar_expect_tx(&full[s], cb);
              bulk_g2s(w + s * p.stage_bytes, p.wts + p.w_off[i] + c * cb,
                       cb, &full[s]);
            }
          }
        }
      }
    }
    return;
  }

  // ---- consumers: two warpgroups of 64 rows each ----
  const int warp = __shfl_sync(0xffffffffu, t >> 5, 0);
  const int wq = warp & 3;           // warp within the warpgroup
  const int lane = t & 31;
  const int tw = t & 127;            // thread within the warpgroup
  const int bar = 1 + wg;            // the warpgroup's named barrier
  uint8_t* a_hi = a + wg * 2 * a_part;
  uint8_t* a_lo = a_hi + a_part;
  float* g_red = red + wg * 4 * kMaxNP;
  int* g_pt = s_pt + wg * kWgRows;
  int* g_gc = s_gc + wg * kWgRows;
  int* g_valid = s_valid + wg * kWgRows;
  const int kg0 = p.kp[0] / 8;       // core matrices along layer 0's K
  // x rows 16-byte aligned: a core-matrix row inside x is two float4 loads
  const bool vec_x = (p.Cin & 3) == 0;
  uint32_t g = 0;                    // ring chunks consumed so far
  if (!kRing) mbar_wait(&full[0], 0);

  for (long long tile = blockIdx.x; tile < p.n_tiles; tile += gridDim.x) {
    const long long row0 = tile * kRows + wg * kWgRows;
    if (tw < kWgRows) {
      const long long r = row0 + tw;
      int pt = 0, gc = 0, valid = 0;
      if (r < p.n_rows) {
        gc = static_cast<int>(r / p.Kp);
        valid = p.mask[r] != 0;
        // clamped so that an index out of range cannot read out of
        // bounds; ball query gives indices in [0, N)
        const long long v = p.idx[r];
        const int j = static_cast<int>(v < 0 ? 0 : (v >= p.N ? p.N - 1 : v));
        pt = (gc / p.M) * p.N + j;
      }
      g_pt[tw] = pt;
      g_gc[tw] = gc;
      g_valid[tw] = valid;
    }
    bar_sync(bar, 128);

    // ---- gather: a thread writes one core-matrix row (8 columns of one
    // row, 16 bytes of hi and of lo); eight consecutive threads fill one
    // 8x8 core matrix ----
#pragma unroll 3
    for (int u = tw; u < kWgRows * kg0; u += 128) {
      const int q = u >> 3;
      const int rg = q / kg0;
      const int c0 = (q - rg * kg0) * 8;
      const int row = rg * 8 + (u & 7);
      float v[8];
      if (!g_valid[row]) {
#pragma unroll
        for (int e = 0; e < 8; ++e) v[e] = 0.0f;
      } else if (vec_x && c0 + 8 <= p.Cin) {
        const float4* src = reinterpret_cast<const float4*>(
            p.x + static_cast<int64_t>(g_pt[row]) * p.Cin + c0);
        const float4 lo4 = __ldg(src), hi4 = __ldg(src + 1);
        v[0] = lo4.x; v[1] = lo4.y; v[2] = lo4.z; v[3] = lo4.w;
        v[4] = hi4.x; v[5] = hi4.y; v[6] = hi4.z; v[7] = hi4.w;
      } else {
#pragma unroll
        for (int e = 0; e < 8; ++e)
          v[e] = input_value(p, g_pt[row], g_gc[row], c0 + e);
      }
      store_split8(a_hi, a_lo, core_offset(row, c0, kg0), v);
    }
    fence_async_smem();
    bar_sync(bar, 128);      // this warpgroup's A rows are written

    for (int i = 0; i < p.n_passes; ++i) {
      if (p.np[i] == 64)
        sa_pass<64, kRing>(p, i, a_hi, a_lo, w, full, empty, g, g_red, g_gc,
                           g_valid, row0, bar, wq, lane, tw);
      else
        sa_pass<128, kRing>(p, i, a_hi, a_lo, w, full, empty, g, g_red,
                            g_gc, g_valid, row0, bar, wq, lane, tw);
    }
  }
}

template <bool kRing>
int launch(const Params& p, size_t smem, void* stream) {
  auto kern = sa_tc_kernel<kRing>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kern, kThreads,
                                                      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  const long long slots = static_cast<long long>(sms) * per_sm;
  const long long blocks = p.n_tiles < slots ? p.n_tiles : slots;
  kern<<<static_cast<unsigned>(blocks), kThreads, smem,
         static_cast<cudaStream_t>(stream)>>>(p);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Shared memory of a block: barriers, A (two warpgroups x hi, lo at the
// widest layer input kp_max), the weights' region (all chunks, or the
// ring), the max partials of 8 warps, the row tables.
extern "C" long long sa_tc_smem(int kp_max, int w_region) {
  return kBarBytes + 4LL * kWgRows * kp_max * 2 + w_region +
         8LL * kMaxNP * 4 + 3LL * kRows * 4;
}

// Per pass: kp, np the padded input and output widths, col0 the first
// output column (0 for a hidden layer); the first n_hidden passes are the
// hidden layers, the rest split the last layer's columns. n_stages: 0 for
// resident weights, else the ring's stages (2..8).
extern "C" int sa_tc_launch(const float* x, const float* pos,
                            const float* centers, const long long* idx,
                            const unsigned char* mask, int B, int N, int M,
                            int Cin, int Kp, const void* wts, const float* epi,
                            int n_passes, int n_hidden, const int* kp,
                            const int* np, const int* col0, int cout_last,
                            int n_stages, float* out, void* stream) {
  if (B < 1 || N < 1 || M < 1 || Cin < 0 || n_passes < 1 ||
      n_passes > kMaxPasses || n_hidden < 0 || n_hidden >= n_passes ||
      (Kp != 16 && Kp != 32 && Kp != 64) ||
      static_cast<long long>(B) * N >= (1LL << 31) ||
      static_cast<long long>(B) * M >= (1LL << 31) ||
      (n_stages != 0 && (n_stages < 2 || n_stages > kMaxStages)))
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.x = x; p.pos = pos; p.centers = centers; p.idx = idx; p.mask = mask;
  p.out = out; p.wts = static_cast<const uint8_t*>(wts); p.epi = epi;
  p.N = N; p.M = M; p.Cin = Cin; p.Kp = Kp;
  p.n_passes = n_passes; p.n_hidden = n_hidden;
  p.n_rows = static_cast<long long>(B) * M * Kp;
  p.n_tiles = (p.n_rows + kRows - 1) / kRows;
  p.kp_max = 0;
  p.stage_bytes = 0;
  long long w_bytes = 0, e_off = 0;
  for (int i = 0; i < n_passes; ++i) {
    const int k = kp[i], n = np[i];
    const bool last = i >= n_hidden;
    // a hidden layer's input is the previous pass's output; every pass of
    // the last layer reads the last hidden layer's output
    const int k_in = i == 0 ? -1 : (i <= n_hidden ? np[i - 1] : kp[i - 1]);
    if ((n != 64 && n != 128) || k < kKStep || k % kKStep ||
        (i == 0 ? k < Cin + 3 : k != k_in) ||
        (last ? (col0[i] != (i == n_hidden ? 0 : col0[i - 1] + np[i - 1]) ||
                 col0[i] >= cout_last)
              : col0[i] != 0))
      return static_cast<int>(cudaErrorInvalidValue);
    p.kp[i] = k;
    p.np[i] = n;
    p.col0[i] = col0[i];
    p.w_off[i] = static_cast<int>(w_bytes);
    p.e_off[i] = static_cast<int>(e_off);
    w_bytes += 4LL * k * n;                 // hi + lo, bf16
    e_off += 3LL * n;
    if (k > p.kp_max) p.kp_max = k;
    if (n * kKStep * 4 > p.stage_bytes) p.stage_bytes = n * kKStep * 4;
  }
  if (cout_last < 1 || cout_last > col0[n_passes - 1] + np[n_passes - 1])
    return static_cast<int>(cudaErrorInvalidValue);
  p.cout_last = cout_last;
  p.w_bytes = static_cast<int>(w_bytes);
  p.n_stages = n_stages;
  const long long w_region =
      n_stages ? static_cast<long long>(n_stages) * p.stage_bytes : w_bytes;
  const long long smem = sa_tc_smem(p.kp_max, static_cast<int>(w_region));
  if (smem > kMaxSmem) return static_cast<int>(cudaErrorInvalidValue);
  return n_stages ? launch<true>(p, static_cast<size_t>(smem), stream)
                  : launch<false>(p, static_cast<size_t>(smem), stream);
}
