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
// NDHWC order), N = Cout, K = taps x Cin in the weight layout
// (kT, kH, kW, Cin, Cout) that the Pallas wrapper builds as `w_flat` (:134);
// the caller reorders the weights once, not per call. Padding is index math
// in the gather (reflect i < 0 -> -i, i >= n -> 2n - 2 - i; replicate clamps;
// zeros is a predicated zero fill of cp.async), so no padded copy of the
// input is made, unlike the Pallas wrapper's jnp.pad (:126-131).
//
// Bound on an H100 SXM: at the decoder's last stage (121 x 128 x 192 voxels,
// 128 -> 128 channels) a conv is 2.6 TFLOP against 190 MB of input and
// output, 2.7 ms of bf16 tensor-core time against 0.06 ms of memory time;
// every conv of the decoder and the upscaler is bound by operations.
//   - bf16 (the decoder): mma.sync m16n8k16 with fp32 accumulators, a 128 x
//     128 output tile per block of 8 warps (each 64 x 32), K in steps of 64
//     channels of one tap, three cp.async stages in XOR-swizzled shared
//     memory (the helpers of flash_common.cuh);
//   - fp32 (the upscaler, which the JAX package runs in fp32): the same
//     tiling with an FFMA inner product, 128 x 128 per block, each thread an
//     8 x 8 register tile, K in steps of 8 channels.
// Left for later work: wgmma, TMA and warp specialisation.
//
// C interface, for ctypes: ltx_conv3d_ndhwc returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a shape
// it does not take (kT not 1 or 3, Cin % 16 != 0, Cout % 8 != 0).

#include "flash_common.cuh"

namespace {

using namespace ltx_flash;

struct ConvParams {
  const void* x;      // (B, T, H, W, Cin)
  const void* wgt;    // (kT, 3, 3, Cin, Cout)
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

constexpr int kStages = 3;
constexpr int kThreads = 256;

// ---------------------------------------------------------------- bf16
constexpr int kBM = 128, kBN = 128, kBK = 64;
constexpr uint32_t kTileA = kBM * kBK * 2;  // [128 voxels][64 channels], 8 chunks a row
constexpr uint32_t kTileB = kBK * kBN * 2;  // [64 channels][128 outputs], 16 chunks a row
constexpr int kSmemBf16 = kStages * (kTileA + kTileB);

__global__ void __launch_bounds__(kThreads) conv3d_bf16_kernel(const ConvParams p) {
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_a = smem_addr(smem);
  const uint32_t s_b = s_a + kStages * kTileA;
  const __nv_bfloat16* x = static_cast<const __nv_bfloat16*>(p.x);
  const __nv_bfloat16* wt = static_cast<const __nv_bfloat16*>(p.wgt);

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int64_t m0 = int64_t(blockIdx.x) * kBM;
  const int n0 = blockIdx.y * kBN;
  const int wm = (warp / 4) * 64, wn = (warp % 4) * 32;  // this warp's 64 x 32 output tile

  // This thread's A chunks: voxels tid / 8 + 32 * i, channels 8 * (tid % 8)
  // of the K step; its B chunks: K rows tid / 16 + 16 * i, outputs
  // 8 * (tid % 16).
  const int a_c = tid % 8, b_c = tid % 16;
  Voxel rows[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) rows[i] = voxel_of(p, m0 + tid / 8 + 32 * i);
  const int k_steps = (p.cin + kBK - 1) / kBK;
  const int n_iter = p.kt * 9 * k_steps;

  auto load = [&](int it, int stage) {
    const int tap = it / k_steps, c0 = (it - tap * k_steps) * kBK;
    const int dt = tap / 9, dh = (tap / 3) % 3, dw = tap % 3;
    const uint32_t sa = s_a + stage * kTileA, sb = s_b + stage * kTileB;
    const int ch = c0 + a_c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool ok;
      const int64_t off = tap_offset(p, rows[i], dt, dh, dw, ok);
      ok = ok && ch < p.cin;
      cp_async16(sa + swz<8>(tid / 8 + 32 * i, a_c), ok ? x + off + ch : x, ok);
    }
    const int n = n0 + b_c * 8;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = tid / 16 + 16 * i;
      const bool ok = c0 + r < p.cin && n < p.cout;
      cp_async16(sb + swz<16>(r, b_c), ok ? wt + (int64_t(tap) * p.cin + c0 + r) * p.cout + n : wt, ok);
    }
  };

  float acc[4][4][4];
#pragma unroll
  for (int mt = 0; mt < 4; ++mt)
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) acc[mt][nt][0] = acc[mt][nt][1] = acc[mt][nt][2] = acc[mt][nt][3] = 0.f;

#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < n_iter) load(s, s);
    cp_async_commit();
  }
  for (int it = 0; it < n_iter; ++it) {
    cp_async_wait<kStages - 2>();
    __syncthreads();  // step it has landed; every warp is done with step it - 1's stage
    const int next = it + kStages - 1;
    if (next < n_iter) load(next, next % kStages);
    cp_async_commit();

    const int stage = it % kStages;
    const uint32_t sa = s_a + stage * kTileA, sb = s_b + stage * kTileB;
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[4][4];
#pragma unroll
      for (int mt = 0; mt < 4; ++mt)
        ldmatrix_x4(a[mt], sa + swz<8>(wm + mt * 16 + (lane % 16), kk * 2 + lane / 16));
#pragma unroll
      for (int np = 0; np < 2; ++np) {
        uint32_t b[4];
        ldmatrix_x4_trans(b, sb + swz<16>(kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2),
                                          wn / 8 + np * 2 + lane / 16));
#pragma unroll
        for (int mt = 0; mt < 4; ++mt) {
          mma_bf16(acc[mt][2 * np], a[mt], b[0], b[1]);
          mma_bf16(acc[mt][2 * np + 1], a[mt], b[2], b[3]);
        }
      }
    }
  }
  cp_async_wait<0>();

  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(p.out);
#pragma unroll
  for (int nt = 0; nt < 4; ++nt) {
    const int n = n0 + wn + nt * 8 + 2 * t4;
    if (n >= p.cout) continue;  // Cout % 8 == 0: n + 1 is in range with n
    const float b0 = p.bias ? p.bias[n] : 0.f, b1 = p.bias ? p.bias[n + 1] : 0.f;
#pragma unroll
    for (int mt = 0; mt < 4; ++mt)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int64_t m = m0 + wm + mt * 16 + g + 8 * half;
        if (m >= p.m) continue;
        *reinterpret_cast<__nv_bfloat162*>(out + m * p.cout + n) =
            __floats2bfloat162_rn(acc[mt][nt][2 * half] + b0, acc[mt][nt][2 * half + 1] + b1);
      }
  }
}

// ---------------------------------------------------------------- fp32
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
  cudaError_t err = cudaFuncSetAttribute(conv3d_bf16_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         kSmemBf16);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(static_cast<unsigned>((p.m + kBM - 1) / kBM), (cout + kBN - 1) / kBN);
  conv3d_bf16_kernel<<<grid, kThreads, kSmemBf16, s>>>(p);
  return static_cast<int>(cudaGetLastError());
}
