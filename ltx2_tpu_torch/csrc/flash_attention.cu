// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * scale) V, bf16 Q/K/V/O, fp32 scores, running max, running
// sum and output accumulator, with an optional key-valid mask (B, T_k).
//
// Replaces the Pallas TPU flash-attention forward reached from
// ltx2_tpu/ops/attention.py: `_flash_attention` (:188, unmasked) and
// `_flash_attention_masked` (:222, key-only SegmentIds: q all 1, kv = the
// key-valid row). T_q may differ from T_k and neither needs to be a multiple
// of a tile: ragged query rows are zero-filled and never stored, ragged and
// invalid keys get a score of -inf. A query row whose keys are all invalid
// gets an output of 0.
//
// On request (non-null l and m) it also writes the softmax residuals that the
// backward (flash_attention_bwd.cu) reads, as Pallas's `save_residuals=True`
// does (also the counterpart of ltx2_tpu/parallel/ring_attention.py:165
// `_flash_impl_residuals`): m = the row max of the scaled logits, l = the row
// sum of exp(s - m), fp32 (B, H, T_q). Without them the launch is unchanged.
//
// Bound on an H100 SXM at the DiT's video self-attention (B=1, H=32,
// T=6144, D=128): the two products are 4*H*T^2*D = 6.2e11 FLOP against about
// 200 MB of Q/K/V/O traffic, i.e. 0.63 ms of bf16 tensor-core time
// (989 TFLOP/s) against 0.06 ms of memory time (3.35 TB/s). Text
// cross-attention (T_k = 1024) is compute-bound as well. The kernel is
// therefore built to keep the tensor cores fed and nothing else big:
//   - both products run on the tensor cores (mma.sync m16n8k16, bf16 in,
//     fp32 accumulate); the (T_q, T_k) scores never leave registers
//     (online softmax, FlashAttention-2 loop order: one block owns 128 query
//     rows and walks every key tile, so O is written once);
//   - K/V tiles are double-buffered in shared memory with cp.async, so the
//     next tile's loads overlap this tile's products;
//   - shared-memory rows are XOR-swizzled in 16-byte chunks, so every
//     ldmatrix phase touches all 32 banks once;
//   - Q/K/V/O are addressed through (batch, token, head) strides, so the
//     DiT's token-major (B, T, H*D) activations are read and written in
//     place, without the head transposes of the JAX path.
// Left for later work: wgmma + TMA with warp specialisation, which Hopper
// needs to go much past half of its bf16 peak.
//
// C interface, for ctypes: ltx_flash_attention_fwd returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a head
// dimension it was not built for.

#include "flash_common.cuh"

namespace {

using namespace ltx_flash;

constexpr int kBlockM = 128;  // query rows per block: 8 warps x 16 rows
constexpr int kBlockN = 64;   // keys per shared-memory tile
constexpr int kWarps = kBlockM / 16;
constexpr int kThreads = kWarps * 32;

struct Params {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  __nv_bfloat16* o;
  const uint8_t* kv_valid;  // (B, T_k) with batch stride kv_sb, or null
  float* l;                 // (B, H, T_q) softmax row sums, or null
  float* m;                 // (B, H, T_q) row maxima of the scaled logits, or null
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t o_sb, o_st, o_sh;
  int64_t kv_sb;
  int t_q, t_k;
  float scale_log2;  // scale * log2(e): the softmax runs on exp2
};

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const Params p) {
  constexpr uint32_t kTileQ = kBlockM * D * 2;
  constexpr uint32_t kTileKV = kBlockN * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_kv = s_q + kTileQ;  // stage s: K at s_kv + 2*s*kTileKV, V right after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;  // accumulator row group, column pair
  const int m0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16;

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh + int64_t(m0) * p.q_st;
  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.kv_sb : nullptr;
  const int n_tiles = (p.t_k + kBlockN - 1) / kBlockN;

  load_tile<D, kBlockM, kThreads>(s_q, q, p.q_st, p.t_q - m0, tid);
  load_tile<D, kBlockN, kThreads>(s_kv, k, p.k_st, p.t_k, tid);
  load_tile<D, kBlockN, kThreads>(s_kv + kTileKV, v, p.v_st, p.t_k, tid);
  cp_async_commit();

  float o[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) o[nt][0] = o[nt][1] = o[nt][2] = o[nt][3] = 0.f;
  float m_i[2] = {-INFINITY, -INFINITY};
  float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums

  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kBlockN;
    const uint32_t s_k = s_kv + (j & 1) * 2 * kTileKV;
    const uint32_t s_v = s_k + kTileKV;
    if (j + 1 < n_tiles) {
      const uint32_t nk = s_kv + ((j + 1) & 1) * 2 * kTileKV;
      const int n1 = n0 + kBlockN;
      load_tile<D, kBlockN, kThreads>(nk, k + int64_t(n1) * p.k_st, p.k_st, p.t_k - n1, tid);
      load_tile<D, kBlockN, kThreads>(nk + kTileKV, v + int64_t(n1) * p.v_st, p.v_st, p.t_k - n1, tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // S = Q K^T: this warp's 16 query rows x 64 keys, in 8 n-tiles of 8.
    float s[kBlockN / 8][4];
#pragma unroll
    for (int jn = 0; jn < kBlockN / 8; ++jn) s[jn][0] = s[jn][1] = s[jn][2] = s[jn][3] = 0.f;
    mma_abt<D, kBlockN>(s, s_q, wrow, s_k, 0, lane);

#pragma unroll
    for (int jn = 0; jn < kBlockN / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[jn][e] *= p.scale_log2;

    if (n0 + kBlockN > p.t_k || valid != nullptr) {
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int col = n0 + jn * 8 + 2 * t4 + e;
          const bool ok = col < p.t_k && (valid == nullptr || valid[col] != 0);
          if (!ok) s[jn][e] = s[jn][2 + e] = -INFINITY;
        }
    }

    // Online softmax. Fragment element (jn, e) lies in row g for e < 2 and
    // row g + 8 for e >= 2; the 4 threads of a quad share each row.
    float alpha[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = -INFINITY;
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn)
        mx = fmaxf(mx, fmaxf(s[jn][2 * i], s[jn][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float m_new = fmaxf(m_i[i], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;  // a row with no valid key yet
      alpha[i] = exp2f(m_i[i] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int jn = 0; jn < kBlockN / 8; ++jn)
#pragma unroll
        for (int e = 2 * i; e < 2 * i + 2; ++e) {
          s[jn][e] = exp2f(s[jn][e] - m_use);
          sum += s[jn][e];
        }
      l_i[i] = l_i[i] * alpha[i] + sum;
      m_i[i] = m_new;
    }
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt) {
      o[nt][0] *= alpha[0];
      o[nt][1] *= alpha[0];
      o[nt][2] *= alpha[1];
      o[nt][3] *= alpha[1];
    }

    // O += P V. Two adjacent score n-tiles form one 16x16 A fragment.
    mma_pb<D, kBlockN>(o, s, s_v, 0, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  __nv_bfloat16* out = p.o + b * p.o_sb + h * p.o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    float l = l_i[i];
    l += __shfl_xor_sync(0xffffffffu, l, 1);
    l += __shfl_xor_sync(0xffffffffu, l, 2);
    const float inv = l > 0.f ? 1.f / l : 0.f;
    const int row = m0 + wrow + g + 8 * i;
    if (row < p.t_q) {
      __nv_bfloat16* dst = out + int64_t(row) * p.o_st + 2 * t4;
#pragma unroll
      for (int nt = 0; nt < D / 8; ++nt)
        *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
            __floats2bfloat162_rn(o[nt][2 * i] * inv, o[nt][2 * i + 1] * inv);
      // Residuals for the backward, in Pallas's convention: m in units of
      // the scaled logits (m_i is in log2 units), l = sum exp(s - m) after the
      // last rescale. A row with no valid key keeps l = 0, m = -inf.
      if (p.l != nullptr && t4 == 0) {
        const int64_t at = (int64_t(b) * gridDim.y + h) * p.t_q + row;
        p.l[at] = l;
        p.m[at] = m_i[i] * 0.6931471805599453f;
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, int batch, int heads, cudaStream_t stream) {
  constexpr int kSmem = kBlockM * D * 2 + 4 * kBlockN * D * 2;  // Q + 2 stages of K and V
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_q + kBlockM - 1) / kBlockM, heads, batch);
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" int ltx_flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const void* kv_valid, void* l, void* m, int batch,
                                       int heads, int t_q,
                                       int t_k, int head_dim, int64_t q_sb, int64_t q_st,
                                       int64_t q_sh, int64_t k_sb, int64_t k_st, int64_t k_sh,
                                       int64_t v_sb, int64_t v_st, int64_t v_sh, int64_t o_sb,
                                       int64_t o_st, int64_t o_sh, int64_t kv_sb, float scale,
                                       void* stream) {
  Params p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.o = static_cast<__nv_bfloat16*>(o);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.l = static_cast<float*>(l);
  p.m = static_cast<float*>(m);
  p.q_sb = q_sb; p.q_st = q_st; p.q_sh = q_sh;
  p.k_sb = k_sb; p.k_st = k_st; p.k_sh = k_sh;
  p.v_sb = v_sb; p.v_st = v_st; p.v_sh = v_sh;
  p.o_sb = o_sb; p.o_st = o_st; p.o_sh = o_sh;
  p.kv_sb = kv_sb;
  p.t_q = t_q;
  p.t_k = t_k;
  p.scale_log2 = scale * 1.4426950408889634f;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return static_cast<int>(launch<128>(p, batch, heads, s));
  if (head_dim == 64) return static_cast<int>(launch<64>(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
