// Implicit-GEMM 3D convolution for Hopper (sm_90a): a kT x 3 x 3 conv (kT =
// 3, or 1 for a per-frame 3 x 3 conv) over channels-last (B, T, H, W, Cin)
// input at strides (sT, sH, sW), each 1 or 2: the padded input (see below)
// sampled on the strided grid, so T_out = (T - 1) / sT + 1 and likewise for
// H and W ('same' output size at stride 1); fp32 accumulation, fp32 bias,
// output rounded once to the input's dtype.
//
// Replaces the Pallas TPU implicit-GEMM conv3d of
// scripts/bench_conv_pallas.py: `conv3d_pallas` (:116, pallas_call :140),
// `conv3d_pallas_v2` (:223, :247) and `conv3d_pallas_v3` (:357, :378). The
// three compute one function and differ only in how they meet Mosaic's
// alignment rules, so this one kernel is the counterpart of all three. Their
// contract is the VAE decoder's conv (ltx2_tpu/models/video_vae/conv.py:87,
// spatial_mode="reflect"): reflect H/W padding and replicate T padding (2
// frames in front when causal, else 1 + 1). The kernel also takes the padding
// rules the JAX package's conv3d_ndhwc takes on the spatial upscaler's path:
// zeros in space and in time (models/upscaler/spatial.py:37-40), with a
// temporal extent of 1 for the resampler's per-frame conv (:81-100).
//
// Strides are the full video VAE's strided causal convs (ltx2_tpu/models/
// video_vae/conv.py:135-170, full_vae.py:97-105): output voxel (t, h, w)
// reads padded input (t sT + dt, h sH + dh, w sW + dw). Only the producer's
// row table knows of them; each kernel is compiled twice, with and without
// the strided row table, so stride 1 keeps its arithmetic (one instance for
// both ran the stride-1 cases S4 and S3 2-2.5 % slower on an H100 80GB).
//
// GEMM view: M = output voxels (B*T_out*H_out*W_out, a tile of consecutive
// voxels in NDHWC order), N = Cout, K = taps x Cin. Padding is index math in the
// gather (reflect i < 0 -> -i, i >= n -> 2n - 2 - i; replicate clamps; zeros
// is a zero-filled cp.async), so no padded copy of the input is made, unlike
// the Pallas wrapper's jnp.pad (:126-131); TMA's im2col mode could only pad
// with zeros.
//
// Bound on an H100 SXM: at the decoder's last stage (121 x 128 x 192 voxels,
// 128 -> 128 channels) a conv is 2.6 TFLOP against 190 MB of input and
// output, 2.7 ms of bf16 tensor-core time against 0.06 ms of memory time;
// every conv of the decoder and the upscaler is bound by operations. What
// holds a kernel back is the operand traffic into the SMs: every K step
// brings a BM x 64 input tile and a BN x 64 weight tile from L2 (the input,
// re-read once per tap, is far larger than what L2 could serve from one
// read), and the tensor cores read both again from shared memory.
//
// bf16 (the decoder), `conv3d_wgmma_kernel`: warp-specialised, persistent
// (one CTA per SM walks output tiles, M tiles fastest, so the input rows the
// CTAs share stay in L2), 3 warpgroups:
//   - a producer warpgroup (setmaxnreg down) fills a ring of kRing stages
//     guarded by full/empty mbarriers. Per tile it builds a row table in
//     shared memory: for each voxel row the frame, row and column parts of
//     the input voxel index that each temporal, vertical and horizontal tap
//     reads (padding is separable, so 9 entries serve 27 taps; kPad where
//     zeros are read). Per K step (one tap, 64 channels) each thread sums
//     three entries for each of its rows and issues 16-byte cp.async into a
//     128-byte-swizzled [BM][64] A tile, zero-filling padding and channels
//     past Cin; the stage's full barrier counts the copies' completion
//     (cp.async.mbarrier.arrive.noinc). One thread loads the B tile by TMA:
//     a box of the K-major (taps, Cout, Cin) weights, zero past Cout and Cin.
//   - two consumer warpgroups (setmaxnreg up) each own BM / 2 rows and run
//     wgmma m64nBNk16 with both operands K-major in shared memory, one
//     product group in flight; fence.proxy.async after each full barrier,
//     as the cp.async writes are generic-proxy writes. A stage is released
//     once the next step's products are issued and its own have completed.
//   - the epilogue adds the fp32 bias and rounds once to bf16, straight
//     from the accumulator fragment, while the producer fills the next
//     tile's stages.
// Tiles (BM x BN), the N tile fitted to Cout: 256 x 48 for Cout <= 48
// (conv_out), 128 x 256 where Cout % 256 == 0 (S1-S3 res convs, the
// upsample convs), else 256 x 128. 256 rows (or 256 outputs) a CTA halve
// the weight (or input) bytes per product against a 128 x 128 tile: 85
// FLOP per byte brought into shared memory instead of 64.
// Left for later: with the products alone or the loads alone the kernel
// runs near the card's bf16 peak or L2's rate, together they overlap only
// in part (probe_conv.py; PERF.md). Reusing the gathered input across the
// 9 spatial taps would cut the bytes the most; a 2-CTA weight multicast and
// L1-cached gathers did not help.
//
// fp32 (the spatial upscaler, which the JAX package runs in fp32 at
// Precision.HIGHEST: models/upscaler/spatial.py:88-94, video_vae/conv.py:
// 144-164), `conv3d_tf32x3_kernel`: 3xTF32 on wgmma. Each operand is split
// as a = hi + lo, hi = a rounded to TF32 (cvt.rna.tf32.f32), lo = a - hi
// (exact in fp32; the tensor core reads its top 19 bits), and a product is
// lo(x) hi(w) + hi(x) lo(w) + hi(x) hi(w) on `wgmma .tf32` with fp32
// accumulators: about 22 mantissa bits of each operand, as XLA meets
// HIGHEST on a TPU by summing bf16 pieces on the matrix unit. Single-pass
// TF32 keeps 11 bits and computes another function; the wrapper's checks
// hold this kernel against a float64 reference (chip_smoke.py). Bound:
// three TF32 products at 495 TFLOP/s, an effective 165 TFLOP/s, 2.5x the
// 67 TFLOP/s of FFMA; the upscaler's 1024 -> 1024 conv at 6144 voxels is
// 348 GFLOP, 2.1 ms (5.2 ms on FFMA). The design, on the bf16 kernel's
// skeleton:
//   - the producer as above, with a K step of one tap and 32 fp32 channels
//     (one 128-byte swizzled row): A [128][32] by cp.async, zero-filled for
//     padding and channels past Cin; B two TMA boxes, hi and lo, of the
//     K-major weight split (2, taps, Cout, Cin) that the module caches
//     (ops/conv3d.py tf32x3_split), zero past Cout and Cin;
//   - two consumer warpgroups, 64 rows each, read their A rows from shared
//     memory into the wgmma register fragment (conflict-free through the
//     swizzle) and split them there; per k8 they issue three RS products
//     m64n128k8, the small terms first. A is double-buffered in registers,
//     so the next step's rows are read and split while this step's products
//     run. wgmma reads no operand that cp.async wrote, so no proxy fence is
//     needed; no branch surrounds a wgmma;
//   - two-level accumulation: a wgmma chain covers kTChain = 2 K steps (8
//     k8 steps, 24 products), then joins an fp32 sum by FADD (round to
//     nearest). The tensor core's accumulation is not IEEE round to nearest:
//     with one chain over all of K (3,456 k8 steps at the upscaler) the
//     error against float64 is about 200x fp32's (probe_conv.py, PERF.md).
//     Short chains bound what its rounding adds up to; the next chain's
//     first A is read before the chain's products drain, so the flush
//     costs little;
//   - 128 x 128 output tiles, persistent CTAs. Where those leave SMs idle
//     (the low-res 1024 -> 1024 conv: 96 tiles for 132 SMs; the final
//     1024 -> 128: 48), K is split into equal ranges (ops/conv3d.py
//     tf32x3_plan); each range writes an fp32 partial into a workspace the
//     wrapper allocates, and `conv3d_tf32x3_sum_kernel` adds them in a
//     fixed order with the bias: no atomics, bitwise reproducible.
// What bounds it in practice: at the bound, a CTA would bring 32 bytes a
// clock from L2 (a 16 KB A tile and 32 KB of weight parts per 1,536
// tensor-core clocks), about L2's rate, and wgmma reads 64 bytes a clock
// of B from shared memory.
//
// C interface, for ctypes: ltx_conv3d_ndhwc takes the weights K-major: for
// fp32 the TF32 split (2, kT * 9, Cout, Cin), for bf16 (kT, 3, 3, Cout,
// Cin); for fp32 also the number of K ranges and, when it is above 1, a
// (ranges, M, Cout) fp32 workspace; and a W-valid flag (the input's W holds
// its halo: W_out = W - 2, no W padding). It returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// it does not take (kT not 1 or 3, a stride not 1 or 2, Cin % 16 != 0,
// Cout % 8 != 0, 2^31 output voxels or more, K ranges that leave one empty,
// W-valid with a W stride or under 3 columns) or weights TMA cannot address.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace ltx_flash;
using namespace ltx_sm90;

struct ConvParams {
  const void* x;      // (B, T, H, W, Cin)
  const void* wgt;    // fp32: the TF32 split (2, kT * 9, Cout, Cin); bf16: (kT, 3, 3, Cout, Cin)
  const float* bias;  // (Cout), or null
  void* out;          // (B, T_out, H_out, W_out, Cout)
  int t, h, w, cin, cout, kt;  // input dims
  int to, ho, wo;              // output dims
  int st, sh, sw;              // strides
  bool strided;                // any stride above 1, or w_valid: the kernels' kStrided instance
  bool w_valid;                // W-valid: x arrives with its W halo (2 columns wider), W is not padded
  int t_front;         // frames of temporal padding in front of the clip
  bool spatial_zeros;  // zeros, else reflect
  bool temporal_zeros; // zeros, else replicate
  int64_t m;           // output voxels, B * T_out * H_out * W_out
};

// ---------------------------------------------------------------- both kernels
constexpr int kRing = 4;         // shared-memory stages of A and B
constexpr int kWgThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kPad = INT32_MIN;  // a row-table entry that reads zero padding

// Reflect (n >= 2) or, with zeros, kPad for an index outside [0, n).
__device__ __forceinline__ int pad_index(int i, int n, bool zeros) {
  if (i >= 0 && i < n) return i;
  if (zeros) return kPad;
  return i < 0 ? -i : 2 * n - 2 - i;
}

// The producer's row table for the output tile at voxel m0, written by its
// 128 threads (thread tid: rows tid, tid + 128, ...): for each voxel row,
// the frame, row and column parts of the input voxel index each tap reads
// (padding is separable, so 9 entries cover 27 taps), int32 [9][BM]; kPad
// where the tap reads zeros, and for rows past M. kStrided: the row's
// output index is split by the output dims and tap d of an axis reads
// input o * s + d - pad; without it (every stride 1, the output dims the
// input's) the stride-1 arithmetic alone is compiled. W-valid (a W-sharded
// rank's input, its halo columns already in place, parallel/ W-sharded
// decode) runs in the kStrided instance: tap d of W reads input column
// o + d, never padding, while T and H keep their rules.
template <int BM, bool kStrided>
__device__ __forceinline__ void build_row_table(const ConvParams& p, int* s_tab, int64_t m0, int tid) {
  const int hw = p.h * p.w;
  for (int r = tid; r < BM; r += 128) {
    const int64_t m = m0 + r;
    int f[3] = {kPad, kPad, kPad}, hh[3] = {kPad, kPad, kPad}, ww[3] = {kPad, kPad, kPad};
    if (m < p.m) {
      if constexpr (kStrided) {
        const int w = static_cast<int>(m % p.wo);
        const int64_t q = m / p.wo;
        const int h = static_cast<int>(q % p.ho);
        const int bt = static_cast<int>(q / p.ho);
        const int t = bt % p.to, b0 = (bt / p.to) * p.t;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          int ti = t * p.st + d - p.t_front;
          if (ti < 0 || ti >= p.t) ti = p.temporal_zeros ? kPad : (ti < 0 ? 0 : p.t - 1);
          f[d] = ti == kPad ? kPad : (b0 + ti) * hw;
          const int hi = pad_index(h * p.sh + d - 1, p.h, p.spatial_zeros);
          hh[d] = hi == kPad ? kPad : hi * p.w;
          ww[d] = p.w_valid ? w * p.sw + d : pad_index(w * p.sw + d - 1, p.w, p.spatial_zeros);
        }
      } else {
        const int w = static_cast<int>(m % p.w);
        const int64_t q = m / p.w;
        const int h = static_cast<int>(q % p.h);
        const int bt = static_cast<int>(q / p.h);
        const int t = bt % p.t, bt0 = bt - t;
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          int ti = t + d - p.t_front;
          if (ti < 0 || ti >= p.t) ti = p.temporal_zeros ? kPad : (ti < 0 ? 0 : p.t - 1);
          f[d] = ti == kPad ? kPad : (bt0 + ti) * hw;
          const int hi = pad_index(h + d - 1, p.h, p.spatial_zeros);
          hh[d] = hi == kPad ? kPad : hi * p.w;
          ww[d] = pad_index(w + d - 1, p.w, p.spatial_zeros);
        }
      }
    }
#pragma unroll
    for (int d = 0; d < 3; ++d) {
      s_tab[d * BM + r] = f[d];
      s_tab[(3 + d) * BM + r] = hh[d];
      s_tab[(6 + d) * BM + r] = ww[d];
    }
  }
}

// ---------------------------------------------------------------- bf16
// Warp-specialised implicit GEMM on wgmma (see the note above). A CTA walks
// output tiles of BM voxels x BN output channels: tile blockIdx.x, then
// every gridDim.x-th, M tiles fastest. K runs in steps of 64 channels of
// one tap, taps outermost.
// Probes of what sets the pace (probe_conv.py), wrong results by design:
// 1 = loads only (no products), 2 = products only (no loads). Probe 3 is
// the fp32 kernel's: one accumulation chain a piece (see there).
#ifndef LTX_CONV_PROBE
#define LTX_CONV_PROBE 0
#endif

template <int BM, int BN>
struct WgTile {
  static constexpr int kRowsPerThread = BM / 16;  // producer: 8 threads a row, 16 rows a pass
  static constexpr int kMI = BM / 128;            // m64 products per consumer warpgroup
  static constexpr uint32_t kA = BM * 128;        // [BM voxels][64 channels], 128-byte swizzle
  static constexpr uint32_t kB = BN * 128;        // [BN outputs][64 channels], 128-byte swizzle
  static constexpr uint32_t kStage = kA + kB;
  static constexpr uint32_t kTable = kRing * kStage;     // int32 [9][BM]: frame, row, column parts
  static constexpr uint32_t kBars = kTable + 9 * BM * 4;  // full[kRing], empty[kRing]
  static constexpr uint32_t kBytes = kBars + 2 * kRing * 8 + 1024;  // + alignment slack
  static_assert(kStage % 1024 == 0, "stages must keep the 1024-byte swizzle alignment");
};

template <int BM, int BN, bool kStrided>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv3d_wgmma_kernel(const __grid_constant__ CUtensorMap wmap, const ConvParams p, int m_tiles, int tiles) {
  using L = WgTile<BM, BN>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  int* s_tab = reinterpret_cast<int*>(smem_raw + (base - smem_addr(smem_raw)) + L::kTable);
  const uint32_t bar_full = base + L::kBars, bar_empty = bar_full + 8 * kRing;
  const int taps = p.kt * 9, k_chunks = (p.cin + 63) / 64, n_iter = taps * k_chunks;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar_full + 8 * s, 128 + 1);  // a cp.async arrival per producer thread + the TMA's
      mbar_init(bar_empty + 8 * s, 8);       // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: A gathered by cp.async, B by TMA ----
    warpgroup_reg_dealloc<kProducerRegs>();
    const int tid = threadIdx.x, chunk = tid % 8, row0 = tid / 8;
    // Row row0 + 16 i, chunk `chunk` of a stage's A tile (row % 8 = row0 % 8).
    const uint32_t a_off = row0 * 128 + ((chunk ^ (row0 & 7)) << 4);
    const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
    if (tid == 0) prefetch_tensor_map(&wmap);
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = int64_t(tile % m_tiles) * BM;
      const int n0 = (tile / m_tiles) * BN;
      named_barrier_sync(1, 128);  // the previous tile's table is no longer read
      build_row_table<BM, kStrided>(p, s_tab, m0, tid);
      named_barrier_sync(1, 128);
      for (int k = 0; k < n_iter; ++k, ++it) {
        const int tap = k / k_chunks, c0 = (k - tap * k_chunks) * 64;
        const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
        int vox[L::kRowsPerThread];
        uint32_t ok = 0;
#pragma unroll
        for (int i = 0; i < L::kRowsPerThread; ++i) {
          const int r = row0 + 16 * i;
          const int a = s_tab[dt * BM + r], b = s_tab[(3 + dh) * BM + r], c = s_tab[(6 + dw) * BM + r];
          vox[i] = a + b + c;
          ok |= static_cast<uint32_t>((a | b | c) >= 0) << i;
        }
        const int ch = c0 + chunk * 8;
        if (ch >= p.cin) ok = 0;  // channels past Cin: zero-filled
        const int st = it % kRing;
        const uint32_t s_a = base + st * L::kStage;
        mbar_wait(bar_empty + 8 * st, ((it / kRing) & 1) ^ 1);
#if LTX_CONV_PROBE == 2
        if (tid == 0) mbar_arrive(bar_full + 8 * st);
#else
        if (tid == 0) {
          mbar_arrive_expect_tx(bar_full + 8 * st, L::kB);
          tma_load_4d(s_a + L::kA, &wmap, bar_full + 8 * st, c0, n0, tap, 0);
        }
#pragma unroll
        for (int i = 0; i < L::kRowsPerThread; ++i) {
          const bool oki = (ok >> i) & 1;
          cp_async16(s_a + a_off + i * 2048, oki ? x + int64_t(vox[i]) * p.cin + ch : x, oki);
        }
#endif
        cp_async_mbar_arrive_noinc(bar_full + 8 * st);
      }
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: wgmma m64nBNk16, both operands K-major ----
    warpgroup_reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;  // this warpgroup's rows: cw * 64 kMI .. + 64 kMI - 1
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
    // A stage is free once every consumer warp has read it.
    auto release = [&](uint32_t stage) {
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    };
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = int64_t(tile % m_tiles) * BM;
      const int n0 = (tile / m_tiles) * BN;
      float acc[L::kMI][BN / 2];
#pragma unroll
      for (int mi = 0; mi < L::kMI; ++mi)
#pragma unroll
        for (int j = 0; j < BN / 2; ++j) acc[mi][j] = 0.f;

      for (int k = 0; k < n_iter; ++k, ++it) {
        const int st = it % kRing;
        mbar_wait(bar_full + 8 * st, (it / kRing) & 1);
        fence_proxy_async();  // the cp.async (generic-proxy) writes, to wgmma's async proxy
        // Addresses are rebuilt every step from an opaque base, so the
        // descriptors do not hold registers across the loop.
        const uint32_t s_a = opaque(base) + st * L::kStage, s_b = s_a + L::kA;
        wgmma_fence();
#if LTX_CONV_PROBE != 1
#pragma unroll
        for (int kk = 0; kk < 4; ++kk)
#pragma unroll
          for (int mi = 0; mi < L::kMI; ++mi)
            wgmma_ss<BN>(acc[mi], wgmma_desc(s_a + (cw * L::kMI + mi) * 8192 + kk * 32, 16, 1024),
                         wgmma_desc(s_b + kk * 32, 16, 1024));
#endif
        wgmma_commit();
        wgmma_wait<1>();  // the previous step's products have read their stage
        if (k > 0) release((it - 1) % kRing);
      }
#pragma unroll
      for (int mi = 0; mi < L::kMI; ++mi) fence_regs(acc[mi]);
      wgmma_wait<0>();
#pragma unroll
      for (int mi = 0; mi < L::kMI; ++mi) fence_regs(acc[mi]);
      release((it - 1) % kRing);

      // Epilogue: + bias in fp32, rounded once to bf16, straight from the
      // accumulator fragment (row 16 warp + g + 8 half, column 8 j + 2 t4).
#pragma unroll
      for (int j = 0; j < BN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        if (n >= p.cout) continue;  // Cout % 8 == 0: n + 1 is in range with n
        const float b0 = p.bias ? p.bias[n] : 0.f, b1 = p.bias ? p.bias[n + 1] : 0.f;
#pragma unroll
        for (int mi = 0; mi < L::kMI; ++mi)
#pragma unroll
          for (int half = 0; half < 2; ++half) {
            const int64_t m = m0 + (cw * L::kMI + mi) * 64 + 16 * warp + g + 8 * half;
            if (m >= p.m) continue;
            *reinterpret_cast<__nv_bfloat162*>(out + m * p.cout + n) =
                __floats2bfloat162_rn(acc[mi][4 * j + 2 * half] + b0, acc[mi][4 * j + 2 * half + 1] + b1);
          }
      }
    }
  }
}

// ---------------------------------------------------------------- fp32
// 3xTF32 implicit GEMM on wgmma (see the note above). The bf16 kernel's
// skeleton with 32-channel K steps: a CTA walks pieces (an output tile of
// 128 voxels x 128 outputs and one of `splits` equal ranges of `steps` K
// steps; M tiles fastest, then N tiles, then ranges), each range a whole
// number of accumulation chains. Steps past the last tap are phantoms: A
// zero, B a valid box, so they add nothing. Probe 3 (probe_conv.py) keeps
// one wgmma chain over a whole piece (the waits stay, the sums stop), to
// measure what the two-level sum buys in accuracy.
constexpr int kTBM = 128, kTBN = 128;  // output tile: voxels x outputs
constexpr int kTChain = 2;             // K steps per wgmma accumulation chain (even)

struct Tf32Tile {
  static constexpr int kRowsPerThread = kTBM / 16;  // producer: 8 threads a row, 16 rows a pass
  static constexpr uint32_t kA = kTBM * 128;        // [128 voxels][32 channels] fp32, 128-byte swizzle
  static constexpr uint32_t kB = kTBN * 128;        // [128 outputs][32 channels] fp32, 128-byte swizzle
  static constexpr uint32_t kStage = kA + 2 * kB;   // A, B hi, B lo
  static constexpr uint32_t kTable = kRing * kStage;
  static constexpr uint32_t kBars = kTable + 9 * kTBM * 4;
  static constexpr uint32_t kBytes = kBars + 2 * kRing * 8 + 1024;
  static_assert(kA % 1024 == 0 && kB % 1024 == 0, "panels must keep the 1024-byte swizzle alignment");
};

// One K step's A fragment of a consumer thread, split: hi[kk] and lo[kk]
// are the wgmma register operands of k8 step kk (columns 8 kk .. 8 kk + 7).
struct SplitA {
  uint32_t hi[4][4], lo[4][4];
};

template <bool kStrided>
__global__ void __launch_bounds__(kWgThreads, 1)
    conv3d_tf32x3_kernel(const __grid_constant__ CUtensorMap wmap, const ConvParams p, float* ws, int m_tiles,
                         int n_tiles, int splits, int steps) {
  using L = Tf32Tile;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  const unsigned char* s_base = smem_raw + (base - smem_addr(smem_raw));
  int* s_tab = reinterpret_cast<int*>(smem_raw + (base - smem_addr(smem_raw)) + L::kTable);
  const uint32_t bar_full = base + L::kBars, bar_empty = bar_full + 8 * kRing;
  const int k_chunks = (p.cin + 31) / 32, n_iter = p.kt * 9 * k_chunks;
  const int pieces = m_tiles * n_tiles * splits;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kRing; ++s) {
      mbar_init(bar_full + 8 * s, 128 + 1);  // a cp.async arrival per producer thread + the TMA's
      mbar_init(bar_empty + 8 * s, 8);       // every consumer warp
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer: A gathered by cp.async, B hi and lo by TMA ----
    warpgroup_reg_dealloc<kProducerRegs>();
    const int tid = threadIdx.x, chunk = tid % 8, row0 = tid / 8;
    // Row row0 + 16 i, chunk `chunk` (4 channels) of a stage's A tile.
    const uint32_t a_off = row0 * 128 + ((chunk ^ (row0 & 7)) << 4);
    const float* x = static_cast<const float*>(p.x);
    if (tid == 0) prefetch_tensor_map(&wmap);
    uint32_t it = 0;
    for (int piece = blockIdx.x; piece < pieces; piece += gridDim.x) {
      const int64_t m0 = int64_t(piece % m_tiles) * kTBM;
      const int n0 = (piece / m_tiles) % n_tiles * kTBN, k0 = piece / (m_tiles * n_tiles) * steps;
      named_barrier_sync(1, 128);  // the previous piece's table is no longer read
      build_row_table<kTBM, kStrided>(p, s_tab, m0, tid);
      named_barrier_sync(1, 128);
      for (int k = k0; k < k0 + steps; ++k, ++it) {
        const bool live = k < n_iter;
        const int tap = live ? k / k_chunks : 0, c0 = live ? (k - tap * k_chunks) * 32 : 0;
        const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
        int vox[L::kRowsPerThread];
        uint32_t ok = 0;
#pragma unroll
        for (int i = 0; i < L::kRowsPerThread; ++i) {
          const int r = row0 + 16 * i;
          const int a = s_tab[dt * kTBM + r], b = s_tab[(3 + dh) * kTBM + r], c = s_tab[(6 + dw) * kTBM + r];
          vox[i] = a + b + c;
          ok |= static_cast<uint32_t>((a | b | c) >= 0) << i;
        }
        const int ch = c0 + chunk * 4;
        if (!live || ch >= p.cin) ok = 0;  // phantom steps and channels past Cin: zero-filled
        const int st = it % kRing;
        const uint32_t s_a = base + st * L::kStage;
        mbar_wait(bar_empty + 8 * st, ((it / kRing) & 1) ^ 1);
        if (tid == 0) {
          mbar_arrive_expect_tx(bar_full + 8 * st, 2 * L::kB);
          tma_load_4d(s_a + L::kA, &wmap, bar_full + 8 * st, c0, n0, tap, 0);
          tma_load_4d(s_a + L::kA + L::kB, &wmap, bar_full + 8 * st, c0, n0, tap, 1);
        }
#pragma unroll
        for (int i = 0; i < L::kRowsPerThread; ++i) {
          const bool oki = (ok >> i) & 1;
          cp_async16(s_a + a_off + i * 2048, oki ? x + int64_t(vox[i]) * p.cin + ch : x, oki);
        }
        cp_async_mbar_arrive_noinc(bar_full + 8 * st);
      }
    }
    cp_async_wait_all();
  } else {
    // ---- consumers: 64 rows each, A split in registers, B from shared memory ----
    warpgroup_reg_alloc<kConsumerRegs>();
    const int cw = wg - 1;
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    // This thread's A rows in a stage: r = 64 cw + 16 warp + g and r + 8
    // (+1024 bytes), both with r % 8 = g, so column 8 kk + t4 (+ 4) sits in
    // 16-byte chunk (2 kk (+ 1)) ^ g: the 32 lanes hit 32 banks.
    const int a_row = (64 * cw + 16 * warp + g) * 128 + 4 * t4;
    const int chains = steps / kTChain;
    float* out = static_cast<float*>(p.out);
    auto release = [&](uint32_t stage) {  // every consumer warp has read the stage
      __syncwarp();
      if (lane == 0) mbar_arrive(bar_empty + 8 * stage);
    };
    // Wait for step `it`'s stage, read this thread's A elements and split
    // them: hi = rounded to TF32, lo = the exact fp32 remainder.
    auto load = [&](SplitA& a, uint32_t it) {
      const int st = it % kRing;
      mbar_wait(bar_full + 8 * st, (it / kRing) & 1);
      const unsigned char* s_a = s_base + st * L::kStage + a_row;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float v = *reinterpret_cast<const float*>(s_a + (i & 1) * 1024 + (((2 * kk + (i >> 1)) ^ g) << 4));
          a.hi[kk][i] = tf32_rna(v);
          a.lo[kk][i] = __float_as_uint(v - __uint_as_float(a.hi[kk][i]));
        }
    };
    // Step `it`'s twelve products into acc, the small terms of each k8
    // first; the chain's first product (first = 1) overwrites acc.
    auto products = [&](float(&acc)[64], const SplitA& a, uint32_t it, int first) {
      const uint32_t s_b = opaque(base) + (it % kRing) * L::kStage + L::kA;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const uint64_t b_hi = wgmma_desc(s_b + kk * 32, 16, 1024), b_lo = wgmma_desc(s_b + L::kB + kk * 32, 16, 1024);
        wgmma_rs_m64n128k8_tf32(acc, a.lo[kk], b_hi, kk == 0 ? !first : 1);
        wgmma_rs_m64n128k8_tf32(acc, a.hi[kk], b_lo, 1);
        wgmma_rs_m64n128k8_tf32(acc, a.hi[kk], b_hi, 1);
      }
      wgmma_commit();
    };
    SplitA ax, ay;  // double-buffered: one step's products read one while the next step fills the other
    float acc[64], sum[64];
#pragma unroll
    for (int j = 0; j < 64; ++j) acc[j] = 0.f;
    uint32_t it = 0;
    for (int piece = blockIdx.x; piece < pieces; piece += gridDim.x) {
      const int64_t m0 = int64_t(piece % m_tiles) * kTBM;
      const int n0 = (piece / m_tiles) % n_tiles * kTBN, split = piece / (m_tiles * n_tiles);
#pragma unroll
      for (int j = 0; j < 64; ++j) sum[j] = 0.f;
      load(ax, it);
      for (int c = 0; c < chains; ++c, it += kTChain) {
        // The chain's steps alternate between ax and ay; a set is refilled
        // once wait<1> has seen the products that read it complete.
#pragma unroll
        for (int j = 0; j < kTChain; j += 2) {
          products(acc, ax, it + j, j == 0 && (LTX_CONV_PROBE != 3 || c == 0));
          if (j > 0) {
            wgmma_wait<1>();
            release((it + j - 1) % kRing);
          }
          load(ay, it + j + 1);
          products(acc, ay, it + j + 1, 0);
          wgmma_wait<1>();
          release((it + j) % kRing);
          if (j + 2 < kTChain) load(ax, it + j + 2);
        }
        if (c + 1 < chains) load(ax, it + kTChain);  // the next chain's first step, while this one ends
        fence_regs(acc);
        wgmma_wait<0>();
        fence_regs(acc);
        release((it + kTChain - 1) % kRing);
        // The chain's sum joins the piece's in an fp32 add (round to nearest).
#pragma unroll
        for (int j = 0; j < 64; ++j) sum[j] = LTX_CONV_PROBE == 3 ? acc[j] : sum[j] + acc[j];
      }

      // Epilogue, straight from the fragment (row 16 warp + g + 8 half,
      // column 8 j + 2 t4): + bias into the output, or the range's partial
      // into the workspace when K is split.
      float* dst = splits > 1 ? ws + int64_t(split) * p.m * p.cout : out;
      const float* bias = splits > 1 ? nullptr : p.bias;
#pragma unroll
      for (int j = 0; j < kTBN / 8; ++j) {
        const int n = n0 + 8 * j + 2 * t4;
        if (n >= p.cout) continue;  // Cout % 8 == 0: n + 1 is in range with n
        const float b0 = bias ? bias[n] : 0.f, b1 = bias ? bias[n + 1] : 0.f;
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int64_t m = m0 + 64 * cw + 16 * warp + g + 8 * half;
          if (m >= p.m) continue;
          *reinterpret_cast<float2*>(dst + m * p.cout + n) =
              make_float2(sum[4 * j + 2 * half] + b0, sum[4 * j + 2 * half + 1] + b1);
        }
      }
    }
  }
}

// out = the K ranges' partials summed in order, + bias: (M, Cout) fp32 as
// float4, n4 = M Cout / 4 per range.
__global__ void conv3d_tf32x3_sum_kernel(const float4* __restrict__ ws, const float* __restrict__ bias,
                                         float4* __restrict__ out, int64_t n4, int cout4, int splits) {
  for (int64_t i = blockIdx.x * int64_t(blockDim.x) + threadIdx.x; i < n4; i += int64_t(gridDim.x) * blockDim.x) {
    float4 s = ws[i];
    for (int r = 1; r < splits; ++r) {
      const float4 v = ws[r * n4 + i];
      s.x += v.x;
      s.y += v.y;
      s.z += v.z;
      s.w += v.w;
    }
    if (bias != nullptr) {
      const float* b = bias + 4 * (i % cout4);
      s.x += b[0];
      s.y += b[1];
      s.z += b[2];
      s.w += b[3];
    }
    out[i] = s;
  }
}

// The bf16 weights as a tensor map over (Cin, Cout, taps), innermost first,
// read in boxes of 64 channels x BN outputs; channels past Cin and outputs
// past Cout read as zero.
template <int BM, int BN>
cudaError_t launch_wgmma(const ConvParams& p, cudaStream_t stream) {
  CUtensorMap wmap;
  const int taps = p.kt * 9;
  const uint64_t dims[4] = {uint64_t(p.cin), uint64_t(p.cout), uint64_t(taps), 1};
  const uint64_t strides[3] = {uint64_t(p.cin) * 2, uint64_t(p.cout) * p.cin * 2, uint64_t(taps) * p.cout * p.cin * 2};
  const uint32_t box[4] = {64, BN, 1, 1};
  if (!encode_tensor_map_4d(&wmap, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, p.wgt, dims, strides, box))
    return cudaErrorInvalidValue;
  constexpr int kSmem = WgTile<BM, BN>::kBytes;
  const auto kern = p.strided ? conv3d_wgmma_kernel<BM, BN, true> : conv3d_wgmma_kernel<BM, BN, false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int m_tiles = static_cast<int>((p.m + BM - 1) / BM);
  const int tiles = m_tiles * ((p.cout + BN - 1) / BN);
  // Persistent: one CTA per SM (its shared memory allows no second).
  kern<<<tiles < sms ? tiles : sms, kWgThreads, kSmem, stream>>>(wmap, p, m_tiles, tiles);
  return cudaGetLastError();
}

// The fp32 weights' TF32 split, (2, taps, Cout, Cin) fp32 (hi, then lo),
// as a tensor map over (Cin, Cout, taps, part), innermost first, read in
// boxes of 32 channels x 128 outputs; channels past Cin and outputs past
// Cout read as zero. K is split into `splits` ranges of `steps` K steps,
// `steps` the whole chains that cover n_iter / splits; each range must hold
// a real step. With splits > 1 the partials go to `ws` ((splits, M, Cout)
// fp32) and a second kernel sums them.
cudaError_t launch_tf32x3(const ConvParams& p, int splits, float* ws, cudaStream_t stream) {
  const int taps = p.kt * 9, n_iter = taps * ((p.cin + 31) / 32);
  if (splits < 1 || (splits > 1 && ws == nullptr)) return cudaErrorInvalidValue;
  const int steps = ((n_iter + splits - 1) / splits + kTChain - 1) / kTChain * kTChain;
  if ((splits - 1) * steps >= n_iter) return cudaErrorInvalidValue;
  CUtensorMap wmap;
  const uint64_t dims[4] = {uint64_t(p.cin), uint64_t(p.cout), uint64_t(taps), 2};
  const uint64_t strides[3] = {uint64_t(p.cin) * 4, uint64_t(p.cout) * p.cin * 4, uint64_t(taps) * p.cout * p.cin * 4};
  const uint32_t box[4] = {32, kTBN, 1, 1};
  if (!encode_tensor_map_4d(&wmap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, p.wgt, dims, strides, box))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Tf32Tile::kBytes;
  const auto kern = p.strided ? conv3d_tf32x3_kernel<true> : conv3d_tf32x3_kernel<false>;
  cudaError_t err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int m_tiles = static_cast<int>((p.m + kTBM - 1) / kTBM), n_tiles = (p.cout + kTBN - 1) / kTBN;
  const int pieces = m_tiles * n_tiles * splits;
  kern<<<pieces < sms ? pieces : sms, kWgThreads, kSmem, stream>>>(wmap, p, ws, m_tiles, n_tiles, splits, steps);
  if ((err = cudaGetLastError()) != cudaSuccess || splits == 1) return err;
  const int64_t n4 = p.m * p.cout / 4;
  const int64_t blocks = (n4 + 255) / 256;
  conv3d_tf32x3_sum_kernel<<<static_cast<unsigned>(blocks < 8 * sms ? blocks : 8 * sms), 256, 0, stream>>>(
      reinterpret_cast<const float4*>(ws), p.bias, static_cast<float4*>(p.out), n4, p.cout / 4, splits);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ltx_conv3d_ndhwc(const void* x, const void* w, const void* bias, void* out, void* workspace,
                                int fp32, int splits, int batch, int t, int h, int w_, int cin, int cout, int kt,
                                int causal, int spatial_zeros, int temporal_zeros, int st, int sh, int sw,
                                int w_valid, void* stream) {
  if ((kt != 1 && kt != 3) || cin % 16 != 0 || cout % 8 != 0 || batch < 1 || t < 1 || h < 1 || w_ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  if (st < 1 || st > 2 || sh < 1 || sh > 2 || sw < 1 || sw > 2) return static_cast<int>(cudaErrorInvalidValue);
  if (w_valid && (sw != 1 || w_ < 3)) return static_cast<int>(cudaErrorInvalidValue);
  ConvParams p;
  p.x = x;
  p.wgt = w;
  p.bias = static_cast<const float*>(bias);
  p.out = out;
  p.t = t;
  p.h = h;
  p.w = w_;
  p.cin = cin;
  p.cout = cout;
  p.kt = kt;
  p.st = st;
  p.sh = sh;
  p.sw = sw;
  p.w_valid = w_valid != 0;
  p.strided = st != 1 || sh != 1 || sw != 1 || p.w_valid;
  p.to = (t - 1) / st + 1;
  p.ho = (h - 1) / sh + 1;
  p.wo = p.w_valid ? w_ - 2 : (w_ - 1) / sw + 1;
  p.t_front = causal ? kt - 1 : (kt - 1) / 2;
  p.spatial_zeros = spatial_zeros != 0;
  p.temporal_zeros = temporal_zeros != 0;
  p.m = int64_t(batch) * p.to * p.ho * p.wo;
  if (int64_t(batch) * t * h * w_ >= (int64_t(1) << 31))
    return static_cast<int>(cudaErrorInvalidValue);  // int32 voxel indices
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) return static_cast<int>(launch_tf32x3(p, splits, static_cast<float*>(workspace), s));
  if (cout <= 48) return static_cast<int>(launch_wgmma<256, 48>(p, s));
  if (cout % 256 == 0) return static_cast<int>(launch_wgmma<128, 256>(p, s));
  return static_cast<int>(launch_wgmma<256, 128>(p, s));
}
