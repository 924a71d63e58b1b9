// Implicit-GEMM 3D convolution for Hopper (sm_90a): a stride-1 kT x 3 x 3
// conv (kT = 3, or 1 for a per-frame 3 x 3 conv) over channels-last
// (B, T, H, W, Cin) input, 'same' output size, fp32 accumulation, fp32 bias,
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
// GEMM view: M = output voxels (B*T*H*W, a tile of consecutive voxels in
// NDHWC order), N = Cout, K = taps x Cin. Padding is index math in the
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
// fp32 (the upscaler, which the JAX package runs in fp32),
// `conv3d_f32_kernel`: a 128 x 128 output tile per block of 8 warps, each
// thread an 8 x 8 register tile of FFMA, K in steps of 8 channels, three
// cp.async stages; TF32 wgmma would compute another function.
//
// C interface, for ctypes: ltx_conv3d_ndhwc takes the weights as
// (kT, 3, 3, Cin, Cout) for fp32 and K-major (kT, 3, 3, Cout, Cin) for bf16;
// it returns the launch's cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a shape it does not take (kT not 1 or 3,
// Cin % 16 != 0, Cout % 8 != 0, 2^31 output voxels or more in bf16) or
// weights TMA cannot address.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace ltx_flash;
using namespace ltx_sm90;

struct ConvParams {
  const void* x;      // (B, T, H, W, Cin)
  const void* wgt;    // (kT, 3, 3, Cin, Cout) for fp32, (kT, 3, 3, Cout, Cin) for bf16
  const float* bias;  // (Cout), or null
  void* out;          // (B, T, H, W, Cout)
  int t, h, w, cin, cout, kt;
  int t_front;         // frames of temporal padding in front of the clip
  bool spatial_zeros;  // zeros, else reflect
  bool temporal_zeros; // zeros, else replicate
  int64_t m;           // output voxels
};

// One output voxel: (b * T, t, h, w); ok = false past the last voxel.
struct Voxel {
  int bt0, t, h, w;
  bool ok;
};

__device__ __forceinline__ Voxel voxel_of(const ConvParams& p, int64_t m) {
  Voxel v;
  v.ok = m < p.m;
  if (!v.ok) m = 0;
  v.w = static_cast<int>(m % p.w);
  int64_t q = m / p.w;
  v.h = static_cast<int>(q % p.h);
  q /= p.h;
  v.t = static_cast<int>(q % p.t);
  v.bt0 = static_cast<int>(q / p.t) * p.t;
  return v;
}

// Element offset of the input voxel that tap (dt, dh, dw) reads for output
// voxel v; ok is cleared where the tap reads zero padding.
__device__ __forceinline__ int64_t tap_offset(const ConvParams& p, const Voxel& v, int dt, int dh,
                                              int dw, bool& ok) {
  ok = v.ok;
  int ti = v.t + dt - p.t_front;
  if (ti < 0 || ti >= p.t) {
    if (p.temporal_zeros) ok = false;
    ti = ti < 0 ? 0 : p.t - 1;  // replicate
  }
  int hi = v.h + dh - 1;
  int wi = v.w + dw - 1;
  if (hi < 0 || hi >= p.h || wi < 0 || wi >= p.w) {
    if (p.spatial_zeros) {
      ok = false;
      hi = wi = 0;
    } else {  // reflect, n >= 2
      hi = hi < 0 ? -hi : (hi >= p.h ? 2 * p.h - 2 - hi : hi);
      wi = wi < 0 ? -wi : (wi >= p.w ? 2 * p.w - 2 - wi : wi);
    }
  }
  return ((int64_t(v.bt0 + ti) * p.h + hi) * p.w + wi) * p.cin;
}

// ---------------------------------------------------------------- bf16
// Warp-specialised implicit GEMM on wgmma (see the note above). A CTA walks
// output tiles of BM voxels x BN output channels: tile blockIdx.x, then
// every gridDim.x-th, M tiles fastest. K runs in steps of 64 channels of
// one tap, taps outermost.
// Probes of what sets the pace (probe_conv.py), wrong results by design:
// 1 = loads only (no products), 2 = products only (no loads).
#ifndef LTX_CONV_PROBE
#define LTX_CONV_PROBE 0
#endif
constexpr int kRing = 4;         // shared-memory stages of A and B
constexpr int kWgThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr int kProducerRegs = 56, kConsumerRegs = 224;
constexpr int kPad = INT32_MIN;  // a row-table entry that reads zero padding

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

// Reflect (n >= 2) or, with zeros, kPad for an index outside [0, n).
__device__ __forceinline__ int pad_index(int i, int n, bool zeros) {
  if (i >= 0 && i < n) return i;
  if (zeros) return kPad;
  return i < 0 ? -i : 2 * n - 2 - i;
}

template <int BM, int BN>
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
    const int hw = p.h * p.w;
    uint32_t it = 0;
    for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
      const int64_t m0 = int64_t(tile % m_tiles) * BM;
      const int n0 = (tile / m_tiles) * BN;
      // Row table: for each voxel row, the frame, row and column parts of
      // the input voxel index each tap reads (separable, so 9 entries cover
      // 27 taps); kPad where the tap reads zeros, and for rows past M.
      named_barrier_sync(1, 128);  // the previous tile's table is no longer read
      for (int r = tid; r < BM; r += 128) {
        const int64_t m = m0 + r;
        int f[3] = {kPad, kPad, kPad}, hh[3] = {kPad, kPad, kPad}, ww[3] = {kPad, kPad, kPad};
        if (m < p.m) {
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
#pragma unroll
        for (int d = 0; d < 3; ++d) {
          s_tab[d * BM + r] = f[d];
          s_tab[(3 + d) * BM + r] = hh[d];
          s_tab[(6 + d) * BM + r] = ww[d];
        }
      }
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
constexpr int kStages = 3;
constexpr int kThreads = 256;
constexpr int kFBM = 128, kFBN = 128, kFBK = 8;
constexpr uint32_t kFTileA = kFBM * kFBK * 4;  // [128 voxels][8 channels]
constexpr uint32_t kFTileB = kFBK * kFBN * 4;  // [8 channels][128 outputs]
constexpr int kSmemF32 = kStages * (kFTileA + kFTileB);

__global__ void __launch_bounds__(kThreads) conv3d_f32_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  float* sm_a = reinterpret_cast<float*>(smem);                   // [stage][kFBM][kFBK]
  float* sm_b = reinterpret_cast<float*>(smem + kStages * kFTileA);  // [stage][kFBK][kFBN]
  const float* x = static_cast<const float*>(p.x);
  const float* wt = static_cast<const float*>(p.wgt);

  const int tid = threadIdx.x;
  const int ty = tid / 16, tx = tid % 16;  // rows ty + 16 i, columns 4 tx + 64 j + e
  const int64_t m0 = int64_t(blockIdx.x) * kFBM;
  const int n0 = blockIdx.y * kFBN;

  // This thread's A chunk: voxel tid / 2, channels 4 * (tid % 2) of the K
  // step; its B chunk: K row tid / 32, outputs 4 * (tid % 32).
  const int a_r = tid / 2, a_c = tid % 2, b_r = tid / 32, b_c = tid % 32;
  const Voxel row = voxel_of(p, m0 + a_r);
  const int k_steps = (p.cin + kFBK - 1) / kFBK;
  const int n_iter = p.kt * 9 * k_steps;

  auto load = [&](int it, int stage) {
    const int tap = it / k_steps, c0 = (it - tap * k_steps) * kFBK;
    const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
    bool ok;
    const int64_t off = tap_offset(p, row, dt, dh, dw, ok);
    const int ch = c0 + a_c * 4;
    ok = ok && ch < p.cin;
    cp_async16(smem_addr(sm_a + stage * kFBM * kFBK + a_r * kFBK + a_c * 4), ok ? x + off + ch : x, ok);
    const int n = n0 + b_c * 4;
    const bool okb = c0 + b_r < p.cin && n < p.cout;
    cp_async16(smem_addr(sm_b + stage * kFBK * kFBN + b_r * kFBN + b_c * 4),
               okb ? wt + (int64_t(tap) * p.cin + c0 + b_r) * p.cout + n : wt, okb);
  };

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();
    const int next = it + kStages - 1;
    if (next < n_iter) load(next, next % kStages);
    cp_async_commit();

    const int stage = it % kStages;
    const float* a_s = sm_a + stage * kFBM * kFBK;
    const float* b_s = sm_b + stage * kFBK * kFBN;
#pragma unroll
    for (int k = 0; k < kFBK; ++k) {
      float a[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) a[i] = a_s[(ty + 16 * i) * kFBK + k];
      const float4 b0 = *reinterpret_cast<const float4*>(b_s + k * kFBN + 4 * tx);
      const float4 b1 = *reinterpret_cast<const float4*>(b_s + k * kFBN + 64 + 4 * tx);
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
  }
  cp_async_wait<0>();

  float* out = static_cast<float*>(p.out);
#pragma unroll
  for (int jh = 0; jh < 2; ++jh) {
    const int n = n0 + 64 * jh + 4 * tx;
    if (n >= p.cout) continue;  // Cout % 8 == 0: n .. n + 3 are in range with n
    float bias[4] = {0.f, 0.f, 0.f, 0.f};
    if (p.bias)
#pragma unroll
      for (int e = 0; e < 4; ++e) bias[e] = p.bias[n + e];
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const int64_t m = m0 + ty + 16 * i;
      if (m >= p.m) continue;
      *reinterpret_cast<float4*>(out + m * p.cout + n) =
          make_float4(acc[i][4 * jh] + bias[0], acc[i][4 * jh + 1] + bias[1], acc[i][4 * jh + 2] + bias[2],
                      acc[i][4 * jh + 3] + bias[3]);
    }
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
  cudaError_t err = cudaFuncSetAttribute(conv3d_wgmma_kernel<BM, BN>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess) return err;
  const int m_tiles = static_cast<int>((p.m + BM - 1) / BM);
  const int tiles = m_tiles * ((p.cout + BN - 1) / BN);
  // Persistent: one CTA per SM (its shared memory allows no second).
  conv3d_wgmma_kernel<BM, BN><<<tiles < sms ? tiles : sms, kWgThreads, kSmem, stream>>>(wmap, p, m_tiles, tiles);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ltx_conv3d_ndhwc(const void* x, const void* w, const void* bias, void* out, int fp32,
                                int batch, int t, int h, int w_, int cin, int cout, int kt,
                                int causal, int spatial_zeros, int temporal_zeros, void* stream) {
  if ((kt != 1 && kt != 3) || cin % 16 != 0 || cout % 8 != 0 || batch < 1 || t < 1 || h < 1 || w_ < 1)
    return static_cast<int>(cudaErrorInvalidValue);
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
  p.t_front = causal ? kt - 1 : (kt - 1) / 2;
  p.spatial_zeros = spatial_zeros != 0;
  p.temporal_zeros = temporal_zeros != 0;
  p.m = int64_t(batch) * t * h * w_;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (fp32) {
    const dim3 grid(static_cast<unsigned>((p.m + kFBM - 1) / kFBM), (cout + kFBN - 1) / kFBN);
    conv3d_f32_kernel<<<grid, kThreads, kSmemF32, s>>>(p);
    return static_cast<int>(cudaGetLastError());
  }
  if (p.m >= (int64_t(1) << 31)) return static_cast<int>(cudaErrorInvalidValue);  // int32 voxel indices
  if (cout <= 48) return static_cast<int>(launch_wgmma<256, 48>(p, s));
  if (cout % 256 == 0) return static_cast<int>(launch_wgmma<128, 256>(p, s));
  return static_cast<int>(launch_wgmma<256, 128>(p, s));
}
