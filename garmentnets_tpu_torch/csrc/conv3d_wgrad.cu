// Filter gradient of a 3x3x3 convolution at stride 1 and padding 1 on
// Hopper's tensor cores (wgmma), f32-accurate (bf16x6): the stage-2
// U-Nets' SwapGradConv3d (models/unet3d.weight_grad on a card).
//
// Replaces no TPU kernel: the JAX U-Net's convolution is lax.conv, which
// XLA compiles. It was added because cuDNN's f32 filter-gradient engines
// (wgrad_alg1 and xmma wgrad) ran at 10-38% of the f32 CUDA-core roofline
// and took the largest block of the stage-2 train step.
//
//   dW[co, ci, kd, kh, kw] =
//       sum_{n,d,h,w} g[n, co, d, h, w] x[n, ci, d+kd-1, h+kh-1, w+kw-1]
//
// with x zero outside the volume. As a GEMM for each tap: K = B*D*H*W
// positions, A one operand (unshifted), B the other shifted by the tap:
// A = g (M = Cout) and B = x (N = Cin), or, where that pads less, A = x
// and B = g shifted the other way (the same sum over K). The products run
// on wgmma.mma_async (m64 n128 k16, bf16 in, f32 accumulate) on operands
// split into three bf16 parts, v = hi + mid + lo, each rounded to nearest
// even (the subtractions are exact), keeping the six products of order 1,
// 2^-8 and 2^-16:
//   a0.b0 + a0.b1 + a1.b0 + a0.b2 + a1.b1 + a2.b0
// (the dropped three are under 2^-24 of the product, f32's own rounding;
// XLA's f32 product at HIGHEST on the TPU makes the same six passes).
//
// Bound (B=24, 32^3; the operations of the 14 or 27 filter gradients):
// UNet3D 1203 GFLOP, six bf16 passes at 989 TFLOP/s 7.3 ms; ResidualUNet3D
// 2082 GFLOP, 12.6 ms. Bytes (each operand's f32 read, its three bf16
// parts written and read once, the output) are ~4 GB a U-Net, ~1.3 ms.
// Tensor-core operations bound it.
//
// Design:
// - Split pass (split_kernel, memory-bound, once per operand): each f32
//   [B, C, D, H, W] tensor becomes three bf16 parts [3][B, D, H, W, Cp],
//   channels-last with C zero-padded to Cp (64-channel atoms for A; 64 or,
//   where that pads less, 32 for B). A position is then a 128- or 64-byte
//   row of an atom, and a tap's shift moves whole rows.
// - Main pass (wgrad_kernel): a chunk is 32 positions that a 5D TMA box
//   (an atom's channels x bw x bh x bd x bn, product 32) covers. The
//   producer warp loads, for each chunk, the A atoms at the box's
//   coordinates and the B atoms at the coordinates shifted by each atom's
//   tap: the TMA zero-fills what lies outside the volume, which is the
//   padding, and boxes that overhang a side that is not a power of two.
//   TMA writes each box in the 128-byte (64-channel) or 64-byte (32-
//   channel) swizzle, which is wgmma's MN-major operand layout (LBO: the
//   next atom, SBO: the next 8 positions), so the tiles go from TMA to the
//   tensor cores untouched. N runs over tap-atoms (tap, B atom): each
//   consumer warpgroup owns an m64 n128 tile; a block holds two of them,
//   128 rows of A by one warpgroup's columns (4-stage ring of 48 KB) or,
//   where A pads to an odd number of atoms, 64 rows by two warpgroups'
//   columns (3 stages of 60 KB). 32-channel B atoms spare UNet3D's
//   32-channel convolutions a half-empty atom.
// - K is long (up to 786 432 positions), so the wrapper splits it over
//   blockIdx.y (split-K) by a plan it makes from the shape (the tile
//   count and the split that fill the SMs in the fewest, fullest waves).
//   Each split writes its partial tile to a workspace and reduce_kernel
//   sums the splits in a fixed order: two launches give the same bits.
// - The tensor cores accumulate in f32 but do not round to nearest at
//   every addition. The five small products go to a second accumulator
//   (their bits below the large sum's last place are not lost at every
//   step), and both are added (FADD) into an f32 sum every kPeriod chunks
//   and restarted, so no rounding sees more than 4 x 32 positions of
//   products. With one accumulator the error against float64 was up to
//   2.2x cuDNN's f32 filter gradient's at two U-Net shapes (PERF.md).
// - The roles, the tile, the box and the split come from the shape alone
//   (the wrapper's plan): both U-Nets run the same code.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <dlfcn.h>
#include <stdint.h>

#include "wgmma_common.cuh"

namespace {

constexpr int kKc = 32;                     // positions a chunk
constexpr int kPeriod = 4;                  // chunks an accumulation period
constexpr int kTaps = 27;
constexpr int kConsumers = 256;             // two warpgroups
constexpr int kThreads = kConsumers + 32;   // + one producer warp
constexpr uint32_t kAAtom = kKc * 128;      // one 64-channel A box, bytes

struct Maps {
  CUtensorMap a[3];   // A's parts [B, D, H, W, mp] (bf16), unshifted
  CUtensorMap b[3];   // B's parts [B, D, H, W, np], shifted by each tap
};

struct Params {
  int bw, bh, bd, bn;      // a chunk's box
  int nbw, nbh, nbd;       // boxes along w, h, d
  int chunks, per_split;   // chunks in all, a split
  int tiles_n, nb;         // N tiles; B atoms a tap (np / BW)
  int sign;                // +1: B is x, shifted by the tap; -1: B is g
  int batch;               // B: an unused tap-atom loads at n >= B (zeros)
  int mp, np;              // A's and B's padded channels
  float* ws;               // [splits][mp][27][np]
};

__host__ __device__ constexpr int stages(int ma) { return ma == 2 ? 4 : 3; }

// BW-channel B atoms a warpgroup's n128 tile holds, and a block's
__host__ __device__ constexpr int wg_atoms(int bw) { return 128 / bw; }
__host__ __device__ constexpr int block_atoms(int ma, int bw) {
  return (ma == 2 ? 1 : 2) * wg_atoms(bw);
}

__host__ __device__ constexpr uint32_t stage_bytes(int ma, int bw) {
  return 3u * (ma * kAAtom + block_atoms(ma, bw) * kKc * bw * 2);
}

__device__ __forceinline__ void tma_load_5d(uint32_t dst,
                                            const CUtensorMap* map, int c0,
                                            int c1, int c2, int c3, int c4,
                                            uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.5d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5, %6}], [%7];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(c4), "r"(smem_addr(bar))
      : "memory");
}

// MA 64-channel A atoms x NA tap-atoms (tap, BW channels of B) a block;
// each consumer warpgroup takes 64 rows of A and 128 / BW tap-atoms
// (n128). A atoms are in the 128-byte swizzle, B atoms in the 128-byte
// (BW 64) or 64-byte (BW 32) one.
template <int MA, int BW>
__global__ void __launch_bounds__(kThreads, 1)
wgrad_kernel(const __grid_constant__ Maps maps, const Params p) {
  static_assert((MA == 1 || MA == 2) && (BW == 64 || BW == 32),
                "a warpgroup's tile is m64 n128");
  constexpr int NA = block_atoms(MA, BW);
  constexpr int kStages = stages(MA);
  constexpr uint32_t kBAtom = kKc * BW * 2;   // one B box, bytes
  constexpr uint32_t kABytes = 3u * MA * kAAtom;
  constexpr uint32_t kStage = stage_bytes(MA, BW);

  extern __shared__ uint8_t smem_raw[];
  const uint32_t raw = smem_addr(smem_raw);
  // the 128-byte swizzle repeats every 1024 bytes: atoms start aligned
  uint8_t* ring = smem_raw + (((raw + 1023u) & ~1023u) - raw);
  uint64_t* full = reinterpret_cast<uint64_t*>(ring + kStages * kStage);
  uint64_t* empty = full + kStages;

  const int t = threadIdx.x;
  const int wg = __shfl_sync(0xffffffffu, t >> 7, 0);
  if (t == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(&full[s], 1);
      mbar_init(&empty[s], kConsumers / 32);   // one arrival per warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int tm = blockIdx.x / p.tiles_n, tn = blockIdx.x % p.tiles_n;
  const int c_begin = blockIdx.y * p.per_split;
  const int n_chunks = min(p.chunks - c_begin, p.per_split);
  const int n_atoms = kTaps * p.nb;

  if (wg == kConsumers / 128) {
    // ---- producer: one thread keeps the ring's TMA loads in flight ----
    if (t == kConsumers) {
      int ac[NA], aw[NA], ah[NA], ad[NA], an[NA];
#pragma unroll
      for (int a = 0; a < NA; ++a) {
        const int j = tn * NA + a;
        const int tap = j / p.nb;
        ac[a] = (j % p.nb) * BW;
        aw[a] = p.sign * (tap % 3 - 1);
        ah[a] = p.sign * ((tap / 3) % 3 - 1);
        ad[a] = p.sign * (tap / 9 - 1);
        an[a] = j < n_atoms ? 0 : p.batch;   // past the batch: zeros
      }
      const uint32_t ring_s = smem_addr(ring);
      for (int i = 0; i < n_chunks; ++i) {
        const int s = i % kStages;
        if (i >= kStages) mbar_wait(&empty[s], ((i / kStages) - 1) & 1);
        mbar_expect_tx(&full[s], kStage);
        int r = c_begin + i;
        const int w0 = (r % p.nbw) * p.bw;
        r /= p.nbw;
        const int h0 = (r % p.nbh) * p.bh;
        r /= p.nbh;
        const int d0 = (r % p.nbd) * p.bd;
        const int n0 = (r / p.nbd) * p.bn;
        const uint32_t st = ring_s + s * kStage;
#pragma unroll
        for (int q = 0; q < 3; ++q) {
#pragma unroll
          for (int m = 0; m < MA; ++m)
            tma_load_5d(st + (q * MA + m) * kAAtom, &maps.a[q],
                        (tm * MA + m) * 64, w0, h0, d0, n0, &full[s]);
#pragma unroll
          for (int a = 0; a < NA; ++a)
            tma_load_5d(st + kABytes + (q * NA + a) * kBAtom, &maps.b[q],
                        ac[a], w0 + aw[a], h0 + ah[a], d0 + ad[a],
                        n0 + an[a], &full[s]);
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup wg, 64 rows of A x 128 columns of B ----
  const int warp = t >> 5, lane = t & 31;
  const int m_atom = MA == 2 ? wg : 0;
  const int a_first = MA == 2 ? 0 : wg * wg_atoms(BW);   // its first atom
  // the second warpgroup's periods end half a period after the first's,
  // so that the tensor cores always have one warpgroup's products queued
  const int phase = wg * (kPeriod / 2);
  // the five small products (orders 2^-8 and 2^-16) go to a second
  // accumulator, so that the large one's roundings do not take their low
  // bits at every step
  float acc[64], cor[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = cor[i] = sum[i] = 0.0f;
  fence_regs(acc);
  fence_regs(cor);
  const uint32_t ring_s = smem_addr(ring);
  for (int i = 0; i < n_chunks; ++i) {
    const int s = i % kStages;
    mbar_wait(&full[s], (i / kStages) & 1);
    const uint32_t st = ring_s + s * kStage;
    wgmma_fence();
#pragma unroll
    for (int ks = 0; ks < kKc / 16; ++ks) {
      // 16 positions are two 8-row groups (SBO apart) into each atom;
      // LBO steps to the next atom along M or N
      uint64_t da[3], db[3];
#pragma unroll
      for (int q = 0; q < 3; ++q) {
        da[q] = make_desc_swizzled<128>(
            st + (q * MA + m_atom) * kAAtom + ks * 16 * 128, kAAtom,
            8 * 128);
        db[q] = make_desc_swizzled<BW * 2>(
            st + kABytes + (q * NA + a_first) * kBAtom + ks * 16 * BW * 2,
            kBAtom, 8 * BW * 2);
      }
      // a period's first products overwrite the accumulators (zero before
      // the first chunk)
      const int keep = (ks > 0 || (i + phase) % kPeriod != 0) ? 1 : 0;
      wgmma_ss_mn128(acc, da[0], db[0], keep);
      wgmma_ss_mn128(cor, da[0], db[1], keep);
      wgmma_ss_mn128(cor, da[1], db[0], 1);
      wgmma_ss_mn128(cor, da[0], db[2], 1);
      wgmma_ss_mn128(cor, da[1], db[1], 1);
      wgmma_ss_mn128(cor, da[2], db[0], 1);
    }
    wgmma_commit();
    const bool ends =
        (i + phase) % kPeriod == kPeriod - 1 || i == n_chunks - 1;
    if (ends)
      wgmma_wait<0>();
    else
      wgmma_wait<1>();
    // the previous chunk's products are done: free its stage, unless the
    // end of its period freed it already
    if (i > 0 && (i - 1 + phase) % kPeriod != kPeriod - 1)
      mbar_arrive_lane0(&empty[(i - 1) % kStages], lane);
    if (ends) {
      fence_regs(acc);
      fence_regs(cor);
#pragma unroll
      for (int r = 0; r < 64; ++r) sum[r] += acc[r] + cor[r];
      mbar_arrive_lane0(&empty[s], lane);
    }
  }

  // ---- epilogue: element r of this thread is row 16*(warp%4) + lane/4
  // + 8*((r/2)%2), column 8*(r/4) + 2*(lane%4) + r%2 of the warpgroup's
  // 64 x 128 tile; column c is channel c%BW of tap-atom a_first + c/BW ----
  const int row = (tm * MA + m_atom) * 64 + (warp & 3) * 16 + (lane >> 2);
  const size_t row_stride = static_cast<size_t>(kTaps) * p.np;
  float* ws = p.ws + static_cast<size_t>(blockIdx.y) * p.mp * row_stride;
#pragma unroll
  for (int k8 = 0; k8 < 16; ++k8) {
    const int col = k8 * 8 + (lane & 3) * 2;
    const int j = tn * NA + a_first + col / BW;
    if (j >= n_atoms) continue;
    // tap-atom j, channel col%BW: column j*BW + col%BW = tap*np + channel
    const size_t c = static_cast<size_t>(j) * BW + col % BW;
#pragma unroll
    for (int hf = 0; hf < 2; ++hf)
      *reinterpret_cast<float2*>(ws + (row + 8 * hf) * row_stride + c) =
          make_float2(sum[4 * k8 + 2 * hf], sum[4 * k8 + 2 * hf + 1]);
  }
}

// parts[q][b][pos][c], q = hi, mid, lo (bf16, channels-last, c < cp) of
// in[b][c][pos] (f32), zeros at c >= C; a 32-channel x 64-position tile a
// block, transposed through shared memory.
__global__ void __launch_bounds__(256)
split_kernel(const float* in, uint8_t* parts, int C, int cp, long long P,
             long long part_bytes) {
  __shared__ float tile[32][65];
  const int b = blockIdx.z, c0 = blockIdx.y * 32;
  const long long p0 = static_cast<long long>(blockIdx.x) * 64;
  const float* src = in + static_cast<size_t>(b) * C * P;
  for (int e = threadIdx.x; e < 32 * 64; e += 256) {
    const int r = e >> 6, col = e & 63;
    const int c = c0 + r;
    const long long pos = p0 + col;
    tile[r][col] = (c < C && pos < P) ? src[c * P + pos] : 0.0f;
  }
  __syncthreads();
  for (int e = threadIdx.x; e < 64 * 16; e += 256) {
    const int col = e >> 4, c = (e & 15) * 2;
    const long long pos = p0 + col;
    if (pos >= P) continue;
    uint8_t* hi = parts + ((b * P + pos) * cp + c0 + c) * 2;
    store_split3(hi, hi + part_bytes, hi + 2 * part_bytes, 0, tile[c][col],
                 tile[c + 1][col]);
  }
}

// out[co][ci][tap] = sum over the splits, in order, of ws[s][co][tap][ci]
// (A is g) or ws[s][ci][tap][co] (A is x); one output channel and 32
// input channels a block.
__global__ void __launch_bounds__(256)
reduce_kernel(const float* ws, float* out, int splits, int cout, int cin,
              int mp, int np, int a_is_x) {
  __shared__ float tile[32 * kTaps];
  const int co = blockIdx.y, ci0 = blockIdx.x * 32;
  const size_t split_stride = static_cast<size_t>(mp) * kTaps * np;
  for (int e = threadIdx.x; e < 32 * kTaps; e += 256) {
    const int tap = e >> 5, i = e & 31;   // neighbours read along ci
    float v = 0.0f;
    if (ci0 + i < cin) {
      const size_t at =
          a_is_x ? (static_cast<size_t>(ci0 + i) * kTaps + tap) * np + co
                 : (static_cast<size_t>(co) * kTaps + tap) * np + ci0 + i;
      for (int s = 0; s < splits; ++s) v += ws[at + s * split_stride];
    }
    tile[i * kTaps + tap] = v;
  }
  __syncthreads();
  const int n = min(32, cin - ci0) * kTaps;
  float* dst = out + (static_cast<size_t>(co) * cin + ci0) * kTaps;
  for (int e = threadIdx.x; e < n; e += 256) dst[e] = tile[e];
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up in the libcuda that the CUDA runtime
// has loaded (this library links no libcuda stub).
EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* h = dlopen("libcuda.so.1", RTLD_NOW | RTLD_GLOBAL);
    if (h != nullptr)
      fn = reinterpret_cast<EncodeTiled>(dlsym(h, "cuTensorMapEncodeTiled"));
  }
  return fn;
}

// A 5D map of one part [B, D, H, W, cp] (bf16) with the chunk's box of
// `atom` channels (64: the 128-byte swizzle, 32: the 64-byte one);
// out-of-bounds elements read as zeros.
bool encode(CUtensorMap* map, const uint8_t* base, int B, int D, int H,
            int W, int cp, int atom, const Params& p) {
  const cuuint64_t row = static_cast<cuuint64_t>(cp) * 2;
  const cuuint64_t dims[5] = {static_cast<cuuint64_t>(cp),
                              static_cast<cuuint64_t>(W),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[4] = {row, row * W, row * W * H, row * W * H * D};
  const cuuint32_t box[5] = {static_cast<cuuint32_t>(atom),
                             static_cast<cuuint32_t>(p.bw),
                             static_cast<cuuint32_t>(p.bh),
                             static_cast<cuuint32_t>(p.bd),
                             static_cast<cuuint32_t>(p.bn)};
  const cuuint32_t unit[5] = {1, 1, 1, 1, 1};
  EncodeTiled fn = encoder();
  return fn != nullptr &&
         fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 5,
            const_cast<uint8_t*>(base), dims, strides, box, unit,
            CU_TENSOR_MAP_INTERLEAVE_NONE,
            atom == 64 ? CU_TENSOR_MAP_SWIZZLE_128B
                       : CU_TENSOR_MAP_SWIZZLE_64B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int MA, int BW>
cudaError_t launch_main(const Maps& maps, const Params& p, int tiles_m,
                        int splits, cudaStream_t stream) {
  auto kern = wgrad_kernel<MA, BW>;
  const size_t smem = stages(MA) * stage_bytes(MA, BW) + 1024 +
                      2 * stages(MA) * sizeof(uint64_t);
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  kern<<<dim3(tiles_m * p.tiles_n, splits), kThreads, smem, stream>>>(maps,
                                                                       p);
  return cudaGetLastError();
}

}  // namespace

// The whole filter gradient: both split passes, the main pass and the
// reduction, on `stream`. grad [B, cout, D, H, W] and x [B, cin, D, H, W]
// f32; out [cout, cin, 3, 3, 3] f32. a_is_x 0: A is grad (mp = cout
// padded to 64) and B is x (np = cin padded to bw); 1: A is x and B is
// grad, shifted the other way. a_parts [3][B, D, H, W, mp] and b_parts
// [3][B, D, H, W, np] bf16 and ws [splits][mp][27][np] f32 are scratch.
// ma: the block's 64-channel A atoms (1 or 2; 2 needs mp % 128 == 0);
// bw: B's atom (64 or 32 channels); the box bw_ x bh x bd x bn covers 32
// positions; splits of per_split chunks. Returns a cudaError_t, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int conv3d_wgrad_launch(const float* grad, const float* x, int B,
                                   int D, int H, int W, int cout, int cin,
                                   int a_is_x, int mp, int np,
                                   void* a_parts, void* b_parts, float* ws,
                                   float* out, int ma, int bw, int box_w,
                                   int box_h, int box_d, int box_n,
                                   int splits, int per_split, void* stream) {
  const int ca = a_is_x ? cin : cout, cb = a_is_x ? cout : cin;
  if (B < 1 || D < 1 || H < 1 || W < 1 || cout < 1 || cin < 1 ||
      (a_is_x != 0 && a_is_x != 1) || (bw != 64 && bw != 32) ||
      (ma != 1 && ma != 2) || mp % (64 * ma) != 0 || mp < ca ||
      mp - ca >= 64 * ma || np % bw != 0 || np < cb || np - cb >= bw ||
      box_w < 1 || box_h < 1 || box_d < 1 || box_n < 1 ||
      box_w * box_h * box_d * box_n != kKc || splits < 1 || per_split < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p;
  p.bw = box_w; p.bh = box_h; p.bd = box_d; p.bn = box_n;
  p.nbw = (W + box_w - 1) / box_w;
  p.nbh = (H + box_h - 1) / box_h;
  p.nbd = (D + box_d - 1) / box_d;
  const long long chunks = static_cast<long long>(p.nbw) * p.nbh * p.nbd *
                           ((B + box_n - 1) / box_n);
  if (chunks > (1ll << 30) ||
      (splits - 1) * static_cast<long long>(per_split) >= chunks ||
      static_cast<long long>(splits) * per_split < chunks)
    return static_cast<int>(cudaErrorInvalidValue);
  p.chunks = static_cast<int>(chunks);
  p.per_split = per_split;
  p.nb = np / bw;
  p.tiles_n = (kTaps * p.nb + block_atoms(ma, bw) - 1) / block_atoms(ma, bw);
  p.sign = a_is_x ? -1 : 1;
  p.batch = B;
  p.mp = mp; p.np = np;
  p.ws = ws;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);

  const long long P = static_cast<long long>(D) * H * W;
  const long long a_part = static_cast<long long>(B) * P * mp * 2;
  const long long b_part = static_cast<long long>(B) * P * np * 2;
  split_kernel<<<dim3((P + 63) / 64, mp / 32, B), 256, 0, st>>>(
      a_is_x ? x : grad, static_cast<uint8_t*>(a_parts), ca, mp, P, a_part);
  split_kernel<<<dim3((P + 63) / 64, np / 32, B), 256, 0, st>>>(
      a_is_x ? grad : x, static_cast<uint8_t*>(b_parts), cb, np, P, b_part);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  Maps maps;
  for (int q = 0; q < 3; ++q) {
    if (!encode(&maps.a[q], static_cast<uint8_t*>(a_parts) + q * a_part, B,
                D, H, W, mp, 64, p) ||
        !encode(&maps.b[q], static_cast<uint8_t*>(b_parts) + q * b_part, B,
                D, H, W, np, bw, p))
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int tiles_m = mp / (64 * ma);
  switch (ma * 100 + bw) {
    case 264: err = launch_main<2, 64>(maps, p, tiles_m, splits, st); break;
    case 164: err = launch_main<1, 64>(maps, p, tiles_m, splits, st); break;
    case 232: err = launch_main<2, 32>(maps, p, tiles_m, splits, st); break;
    default: err = launch_main<1, 32>(maps, p, tiles_m, splits, st); break;
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  reduce_kernel<<<dim3((cin + 31) / 32, cout), 256, 0, st>>>(
      ws, out, splits, cout, cin, mp, np, a_is_x);
  return static_cast<int>(cudaGetLastError());
}
