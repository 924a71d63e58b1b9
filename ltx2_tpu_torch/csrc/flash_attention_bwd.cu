// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of non-causal
// O = softmax(Q K^T * scale) V, bf16 operands and gradients, fp32 scores,
// probabilities and accumulators, with the optional key-valid mask (B, T_k)
// of the forward.
//
// Replaces the Pallas TPU backward that the custom VJP of the upstream
// flash attention reaches from ltx2_tpu/ops/attention.py (`_flash_attention`
// :188 and `_flash_attention_masked` :222, made differentiable by
// `_full_block_sizes` :165): both `_flash_attention_bwd_dkv` (:941,
// pallas_call :1121) and `_flash_attention_bwd_dq` (:1287, pallas_call
// :1456) of jax/experimental/pallas/ops/tpu/flash_attention.py, in one
// kernel. The probabilities are recomputed from the forward's residuals:
// P = exp(S - m) / l, dP = dO V^T, dS = P * (dP - Di) with Di = rowsum(dO * O)
// (computed by the caller, as upstream does outside its kernels),
// dV = P^T dO, dK = dS^T Q * scale, dQ = dS K * scale.
//
// Bound on an H100 SXM at the DiT's video self-attention (B=1, H=32,
// T=6144, D=128): five products of 2*H*T^2*D FLOP each = 1.55e12 FLOP,
// 1.56 ms at 989 TFLOP/s, against about 350 MB of Q/K/V/O/dO/dQ/dK/dV
// traffic, 0.1 ms at 3.35 TB/s: compute-bound. Pallas splits the work so
// that each gradient is written once without atomics, which recomputes S
// and dP in the dq kernel (seven products). Here one CTA owns 128 keys of
// one (batch, head) and walks every 64-row query tile, running the five
// products once each on wgmma (bf16 in, fp32 accumulate):
//   S^T = K Q^T, dP^T = V dO^T     (m64n64 a warpgroup, K-major operands)
//   P^T = exp2(S^T scale log2(e) - lse2[q]), dS^T = P^T (dP^T - Di[q]),
//   rounded to bf16 in registers; dS^T also into shared memory
//   dV += P^T dO, dK += dS^T Q     (m64n{D}; A from registers, dO and Q
//                                   read through the transpose bit)
//   dQ_part = dS K                 (m64n64; dS^T and K read transposed)
// dK and dV stay in registers and are stored once per CTA; each key block's
// dQ_part (times scale) is added into a token-major fp32 accumulator by
// TMA bulk reduce-add, which the caller zeroes first and rounds to bf16
// after. So dK and dV are bitwise reproducible, while dQ's fp32 sum runs over
// the key blocks in the order the CTAs finish, which changes from run to run
// (within the tolerances; the Pallas kernels are deterministic). Registers
// are the constraint: dK and dV hold 128 fp32 a thread, so dV and dK finish
// before the dQ product starts, and no branch surrounds a wgmma at D = 128;
// otherwise ptxas spilled and serialised the products.
//
// Roles: warpgroup 0 is the producer (one warp issues the TMA loads: K and
// V once, Q and dO tiles into a ring of kStages stages guarded by full/empty
// mbarriers, and writes each tile's lse2 and Di rows); warpgroups 1 and 2
// are consumers, each owning 64 of the block's keys, with the producer's
// registers moved to them by setmaxnreg. The two consumers split dQ_part's
// D columns (at D = 64 the first takes them all). Any T_q, T_k: TMA
// zero-fills the ragged tiles, padded and all-masked query rows get
// lse2 = +inf (P = 0), padded and invalid keys P = 0, and the reduce-add
// drops rows past T_q. Q, K, V and dO are read through 4-D tensor maps over
// their (batch, token, head) strides, so the DiT's token-major activations
// go in without transposes, and dK, dV come out in the strides given.
//
// C interface, for ctypes: ltx_flash_attention_bwd launches the kernel and
// returns the launch's cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head dimension it was not built for or a
// tensor TMA cannot address.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace ltx_sm90;

constexpr int kKeys = 128;     // keys per CTA: two consumer warpgroups x 64
constexpr int kQTile = 64;     // query rows per tile
constexpr int kStages = 2;     // Q/dO ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t kPanelKV = kKeys * 128;  // one 64-column panel of K or V
constexpr uint32_t kPanelQ = kQTile * 128;  // one 64-column panel of Q or dO
constexpr uint32_t kDsTile = kKeys * kQTile * 2;  // dS^T, bf16
constexpr uint32_t kDqBox = kQTile * 128;         // 64 rows x 32 fp32
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory layout (byte offsets from a 1024-aligned base).
template <int D>
struct Smem {
  static constexpr uint32_t kKV = kPanelKV * (D / 64);
  static constexpr uint32_t kQ = kPanelQ * (D / 64);
  static constexpr int kDqGroups = D / 64;  // consumer warpgroups that compute dQ_part
  static constexpr uint32_t k = 0;
  static constexpr uint32_t v = kKV;
  static constexpr uint32_t qdo = 2 * kKV;  // stage s: Q at qdo + 2 s kQ, dO kQ after
  static constexpr uint32_t ds = qdo + kStages * 2 * kQ;  // two dS^T buffers
  static constexpr uint32_t dq = ds + 2 * kDsTile;         // per dQ warpgroup: two fp32 boxes
  static constexpr uint32_t stats = dq + kDqGroups * 2 * kDqBox;  // lse2[kStages][64], Di[kStages][64]
  static constexpr uint32_t bars = stats + kStages * 2 * kQTile * 4;  // kv_full, q_full[], q_empty[]
  static constexpr uint32_t bytes = bars + (1 + 2 * kStages) * 8 + 1024;  // + alignment slack
};

struct Maps {
  CUtensorMap q, k, v, dout;  // bf16, dims (D, T, H, B), boxes of 64 columns
  CUtensorMap dq;             // fp32 accumulator, token-major (B, T_q, H, D), boxes of 32 x 64
};

struct BwdParams {
  const float* l;   // (B, H, T_q) forward residuals
  const float* m;
  const float* di;  // (B, H, T_q) rowsum(dO * O)
  const uint8_t* kv_valid;  // (B, T_k) with batch stride kv_sb, or null
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  int64_t kv_sb;
  int64_t dk_sb, dk_st, dk_sh;
  int64_t dv_sb, dv_st, dv_sh;
  int t_q, t_k;
  float scale;       // softmax scale: dQ and dK carry it
  float scale_log2;  // scale * log2(e)
};

// Store a warpgroup's 64 x D fp32 accumulator as bf16 rows, times `mul`,
// skipping keys at or past t_k.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t stride, int row0, int rows,
                                           const float (&acc)[D / 2], float mul, int g, int t4) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= rows) continue;
    __nv_bfloat16* dst = base + int64_t(row) * stride + 2 * t4;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<__nv_bfloat162*>(dst + 8 * j) =
          __floats2bfloat162_rn(acc[4 * j + 2 * i] * mul, acc[4 * j + 2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_bwd_kernel(const __grid_constant__ Maps maps,
                                                                const BwdParams p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (ltx_flash::smem_addr(smem_raw) + 1023) & ~1023u;
  unsigned char* base_ptr = smem_raw + (base - ltx_flash::smem_addr(smem_raw));
  float* s_lse = reinterpret_cast<float*>(base_ptr + L::stats);  // [kStages][64]
  float* s_di = s_lse + kStages * kQTile;                         // [kStages][64]
  const uint32_t bar_kv = base + L::bars;
  const uint32_t bar_full = bar_kv + 8;                // + 8 s
  const uint32_t bar_empty = bar_full + 8 * kStages;   // + 8 s

  const int n0 = blockIdx.x * kKeys, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (p.t_q + kQTile - 1) / kQTile;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_full + 8 * s, 1);
      mbar_init(bar_empty + 8 * s, 2 * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    warpgroup_reg_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      if (lane == 0) {
        prefetch_tensor_map(&maps.q);
        prefetch_tensor_map(&maps.dout);
        mbar_arrive_expect_tx(bar_kv, 2 * L::kKV);
        for (int c = 0; c < D / 64; ++c) {
          tma_load_4d(base + L::k + c * kPanelKV, &maps.k, bar_kv, 64 * c, n0, h, b);
          tma_load_4d(base + L::v + c * kPanelKV, &maps.v, bar_kv, 64 * c, n0, h, b);
        }
      }
      const int64_t stats = (int64_t(b) * gridDim.y + h) * p.t_q;
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        mbar_wait(bar_empty + 8 * st, ((j / kStages) & 1) ^ 1);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int r = j * kQTile + lane + 32 * i;
          const bool ok = r < p.t_q;
          s_lse[st * kQTile + lane + 32 * i] = ok ? ltx_flash::row_lse2(p.l[stats + r], p.m[stats + r]) : INFINITY;
          s_di[st * kQTile + lane + 32 * i] = ok ? p.di[stats + r] : 0.f;
        }
        __syncwarp();
        if (lane == 0) {
          const uint32_t s_q = base + L::qdo + st * 2 * L::kQ;
          mbar_arrive_expect_tx(bar_full + 8 * st, 2 * L::kQ);
          for (int c = 0; c < D / 64; ++c) {
            tma_load_4d(s_q + c * kPanelQ, &maps.q, bar_full + 8 * st, 64 * c, j * kQTile, h, b);
            tma_load_4d(s_q + L::kQ + c * kPanelQ, &maps.dout, bar_full + 8 * st, 64 * c, j * kQTile, h, b);
          }
        }
      }
    }
  } else {
    // ---- consumers ----
    warpgroup_reg_alloc<240>();
    const int cw = wg - 1;  // this warpgroup owns keys n0 + 64 cw .. + 63
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const int row0 = 64 * cw + 16 * warp;  // this warp's first key row in the block
    const bool dq_group = L::kDqGroups == 2 || cw == 0;  // constant at D = 128: no branch around wgmma

    // A padded or invalid key has P = 0, so its dK, dV and dS rows are 0.
    bool key_ok[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = n0 + row0 + g + 8 * i;
      key_ok[i] = key < p.t_k && (p.kv_valid == nullptr || p.kv_valid[b * p.kv_sb + key] != 0);
    }

    float dk[D / 2], dv[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) dk[i] = dv[i] = 0.f;

    mbar_wait(bar_kv, 0);

    for (int j = 0; j < n_tiles; ++j) {
      const int st = j % kStages;
      mbar_wait(bar_full + 8 * st, (j / kStages) & 1);
      // Addresses are rebuilt every tile from an opaque base: hoisted out of
      // the loop, the descriptors would hold registers the accumulators need.
      const uint32_t tile = opaque(base);
      const uint32_t s_k = tile + L::k, s_v = tile + L::v;
      const uint32_t s_q = tile + L::qdo + st * 2 * L::kQ;
      const uint32_t s_do = s_q + L::kQ;
      const uint32_t s_ds = tile + L::ds + (j & 1) * kDsTile;

      // S^T = K Q^T and dP^T = V dO^T over D, this warpgroup's 64 keys x 64
      // queries (K-major operands: a k-step is 32 bytes inside a panel).
      float s[32], dp[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kPanelKV + 64 * cw * 128 + (kk % 4) * 32;
        const uint32_t bq = (kk / 4) * kPanelQ + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(s, wgmma_desc(s_k + a, 16, 1024), wgmma_desc(s_q + bq, 16, 1024), kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t a = (kk / 4) * kPanelKV + 64 * cw * 128 + (kk % 4) * 32;
        const uint32_t bq = (kk / 4) * kPanelQ + (kk % 4) * 32;
        wgmma_ss_m64n64<0, 0>(dp, wgmma_desc(s_v + a, 16, 1024), wgmma_desc(s_do + bq, 16, 1024), kk > 0);
      }
      wgmma_commit();
      fence_regs(s);
      fence_regs(dp);
      wgmma_wait<0>();
      fence_regs(s);
      fence_regs(dp);

      // P^T = exp2(S^T scale log2(e) - lse2[q]) and dS^T = P^T (dP^T - Di[q]),
      // rounded to bf16 as the register A operands of dV and dK (columns
      // 16 kk .. 16 kk + 15 of the accumulator layout make k-step kk), and
      // dS^T also into this warpgroup's rows of the dS^T tile (128 keys x 64
      // queries, 128-byte swizzle) for the dQ product.
      const float* lse = s_lse + st * kQTile;
      const float* di = s_di + st * kQTile;
      uint32_t pa[4][4], da[4][4];
#pragma unroll
      for (int jn = 0; jn < 8; ++jn)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const int e = 4 * jn + 2 * i, col = 8 * jn + 2 * t4;
          const float p0 = key_ok[i] ? exp2_approx(s[e] * p.scale_log2 - lse[col]) : 0.f;
          const float p1 = key_ok[i] ? exp2_approx(s[e + 1] * p.scale_log2 - lse[col + 1]) : 0.f;
          const int r = row0 + g + 8 * i;
          pa[jn / 2][(jn % 2) * 2 + i] = pack_bf16x2(p0, p1);
          da[jn / 2][(jn % 2) * 2 + i] = pack_bf16x2(p0 * (dp[e] - di[col]), p1 * (dp[e + 1] - di[col + 1]));
          st_shared_b32(s_ds + r * 128 + ((jn ^ (r & 7)) << 4) + t4 * 4, da[jn / 2][(jn % 2) * 2 + i]);
        }
      fence_proxy_async();

      // dV += P^T dO and dK += dS^T Q, A from registers, B = the dO / Q tile
      // read MN-major (a k-step is 16 query rows; LBO is the panel stride).
      // They finish before dQ starts, so the A operands are dead by the time
      // the dQ accumulator is live: with both at once ptxas spilled and
      // serialised the products.
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(dv, pa[kk], wgmma_desc(s_do + kk * 2048, kPanelQ, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) wgmma_rs<D, 1>(dk, da[kk], wgmma_desc(s_q + kk * 2048, kPanelQ, 1024));
      wgmma_commit();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      wgmma_wait<0>();
      fence_regs(dv);
      fence_regs(dk);
      fence_regs(pa);
      fence_regs(da);
      mbar_arrive(bar_empty + 8 * st);  // dQ reads no Q, dO, lse2 or Di of this stage
      named_barrier_sync(1, 256);       // both halves of dS^T are in place

      // dQ_part = dS K over the block's 128 keys, this warpgroup's 64 columns:
      // A = dS^T read MN-major, B = the K panel read MN-major (k-step = 16 keys).
      float dq[32];
      if (dq_group) {
        wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kKeys / 16; ++kk)
          wgmma_ss_m64n64<1, 1>(dq, wgmma_desc(s_ds + kk * 2048, kPanelQ, 1024),
                                wgmma_desc(s_k + cw * kPanelKV + kk * 2048, kPanelKV, 1024), kk > 0);
        wgmma_commit();
      }
      fence_regs(dq);
      wgmma_wait<0>();
      fence_regs(dq);

      if (dq_group) {
        // Stage dQ_part * scale as two fp32 boxes of 64 rows x 32 columns
        // (128-byte swizzle) and add them into the accumulator.
        const uint32_t s_dq = tile + L::dq + cw * 2 * kDqBox;
        if (tid == 0) bulk_wait_read();  // the previous tile's reduce has read the staging
        named_barrier_sync(2 + cw, 128);
#pragma unroll
        for (int jn = 0; jn < 8; ++jn)
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const int r = 16 * warp + g + 8 * i;
            const int chunk = 2 * (jn % 4) + t4 / 2;
            const uint32_t addr = s_dq + (jn / 4) * kDqBox + r * 128 + ((chunk ^ (r & 7)) << 4) + (t4 % 2) * 8;
            st_shared_v2_f32(addr, dq[4 * jn + 2 * i] * p.scale, dq[4 * jn + 2 * i + 1] * p.scale);
          }
        fence_proxy_async();
        named_barrier_sync(2 + cw, 128);
        if (tid == 0) {
          tma_reduce_add_4d(&maps.dq, s_dq, 64 * cw, j * kQTile, h, b);
          tma_reduce_add_4d(&maps.dq, s_dq + kDqBox, 64 * cw + 32, j * kQTile, h, b);
          bulk_commit();
        }
      }
    }
    if (dq_group && tid == 0) bulk_wait();  // the staging stays until the last reduce has run

    store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh + int64_t(n0) * p.dk_st, p.dk_st, row0, p.t_k - n0, dk, p.scale,
                  g, t4);
    store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh + int64_t(n0) * p.dv_st, p.dv_st, row0, p.t_k - n0, dv, 1.f, g,
                  t4);
  }
}

// Tensor map of a bf16 (B, H, T, D) tensor with (batch, token, head)
// element strides, read in boxes of `rows` tokens x 64 columns.
bool bf16_map(CUtensorMap* map, const void* ptr, int batch, int heads, int t, int d, const int64_t* s, int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(t), uint64_t(heads), uint64_t(batch)};
  const uint64_t strides[3] = {uint64_t(s[1]) * 2, uint64_t(s[2]) * 2, uint64_t(s[0]) * 2};
  const uint32_t box[4] = {64, uint32_t(rows), 1, 1};
  return encode_tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, box);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq_acc,
                   const BwdParams& p, int batch, int heads, const int64_t* s, cudaStream_t stream) {
  Maps maps;
  const uint64_t acc_dims[4] = {uint64_t(D), uint64_t(p.t_q), uint64_t(heads), uint64_t(batch)};
  const uint64_t acc_strides[3] = {uint64_t(heads) * D * 4, uint64_t(D) * 4, uint64_t(p.t_q) * heads * D * 4};
  const uint32_t acc_box[4] = {32, kQTile, 1, 1};
  if (!bf16_map(&maps.q, q, batch, heads, p.t_q, D, s, kQTile) ||
      !bf16_map(&maps.k, k, batch, heads, p.t_k, D, s + 3, kKeys) ||
      !bf16_map(&maps.v, v, batch, heads, p.t_k, D, s + 6, kKeys) ||
      !bf16_map(&maps.dout, dout, batch, heads, p.t_q, D, s + 9, kQTile) ||
      !encode_tensor_map_4d(&maps.dq, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, dq_acc, acc_dims, acc_strides, acc_box))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_k + kKeys - 1) / kKeys, heads, batch);  // the key blocks of one head run together
  flash_bwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(maps, p);
  return cudaGetLastError();
}

}  // namespace

// strides: 19 int64 = (batch, token, head) strides of q, k, v, dO, dK, dV in
// elements, then the batch stride of kv_valid. dq_acc: zeroed contiguous fp32
// (B, T_q, H, D), to which the kernel adds dQ (scale included).
extern "C" int ltx_flash_attention_bwd(const void* q, const void* k, const void* v, const void* dout,
                                       void* dq_acc, void* dk, void* dv, const void* l, const void* m,
                                       const void* di, const void* kv_valid, int batch, int heads, int t_q,
                                       int t_k, int head_dim, const int64_t* strides, float scale,
                                       void* stream) {
  BwdParams p;
  p.l = static_cast<const float*>(l);
  p.m = static_cast<const float*>(m);
  p.di = static_cast<const float*>(di);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.dk_sb = strides[12]; p.dk_st = strides[13]; p.dk_sh = strides[14];
  p.dv_sb = strides[15]; p.dv_st = strides[16]; p.dv_sh = strides[17];
  p.kv_sb = strides[18];
  p.t_q = t_q;
  p.t_k = t_k;
  p.scale = scale;
  p.scale_log2 = scale * kLog2e;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return static_cast<int>(launch<128>(q, k, v, dout, dq_acc, p, batch, heads, strides, s));
  if (head_dim == 64) return static_cast<int>(launch<64>(q, k, v, dout, dq_acc, p, batch, heads, strides, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
