// Flash-attention forward for Hopper (sm_90a): non-causal
// softmax(Q K^T * scale) V, bf16 Q/K/V/O, fp32 scores, running max, running
// sum and output accumulator, with an optional key-valid mask (B, T_k).
//
// Replaces the Pallas TPU flash-attention forward reached from
// ltx2_tpu/ops/attention.py: `_flash_attention` (:188, unmasked) and
// `_flash_attention_masked` (:222, key-only SegmentIds: q all 1, kv = the
// key-valid row). T_q may differ from T_k and neither needs to be a multiple
// of a tile: TMA zero-fills ragged tiles, rows past T_q are never stored, and
// ragged and invalid keys get a score of -inf. A query row whose keys are all
// invalid gets an output of 0.
//
// On request (non-null l and m) it also writes the softmax residuals that the
// backward (flash_attention_bwd.cu) reads, as Pallas's `save_residuals=True`
// does (also the counterpart of ltx2_tpu/parallel/ring_attention.py:165
// `_flash_impl_residuals`): m = the row max of the scaled logits, l = the row
// sum of exp(s - m), fp32 (B, H, T_q); a row with no valid key gets l = 0,
// m = -inf. Without them the launch is unchanged.
//
// Bound on an H100 SXM at the DiT's video self-attention (B=1, H=32,
// T=6144, D=128): the two products are 4*H*T^2*D = 6.2e11 FLOP against about
// 200 MB of Q/K/V/O traffic, i.e. 0.63 ms of bf16 tensor-core time
// (989 TFLOP/s) against 0.06 ms of memory time (3.35 TB/s). Text
// cross-attention (T_k = 1024) is compute-bound as well. Beside the products
// each score costs an FFMA, an ex2 on the special-function unit (16 a clock
// per SM, half the tensor cores' time at D = 128), a max and an add, so the
// softmax has to run while the tensor cores work. The design:
//   - one CTA owns 128 query rows of one (batch, head) and walks every key
//     tile (FlashAttention-2 loop order: O is written once). Warpgroup 0 is
//     the producer: one warp issues TMA loads of Q once and of 128-key K and
//     V tiles into a ring of kStages stages, K and V with full/empty
//     mbarriers of their own (a K stage is refilled as soon as its scores are
//     computed), and writes each tile's key-valid bits. Warpgroups 1 and 2
//     are consumers, 64 query rows each, with the producer's registers moved
//     to them by setmaxnreg;
//   - S = Q K^T is one wgmma m64n128 chain from shared memory (both operands
//     K-major); O += P V is wgmma m64nD with P from registers (the scores
//     rounded to bf16 in place) and V read MN-major through the transpose
//     bit. The (T_q, T_k) scores never leave registers;
//   - the softmax folds the scale into one FFMA before ex2.approx:
//     P = 2^(s scale log2(e) - m scale log2(e)), m the running max of the raw
//     scores (0 while a row has seen no valid key);
//   - the softmax runs while the tensor cores work, in two ways at once.
//     Within a warpgroup, S of tile j and P V of tile j - 1 are issued
//     together, the softmax of tile j runs while P V is on the tensor cores,
//     and O is rescaled before the next P V is issued. Between the two
//     warpgroups, named barriers make them take turns to issue their
//     products ("ping-pong"), so one's softmax runs during the other's
//     products. Both were probed on the card; together they beat the
//     first alone at every shape of the paths (PERF.md), and a third K/V
//     stage gained nothing;
//   - O is normalised in registers, staged as bf16 in the consumer's own rows
//     of the Q tile and written by TMA stores, which drop rows past T_q;
//   - Q/K/V/O are read and written through 4-D tensor maps over their
//     (batch, token, head) strides, so the DiT's token-major (B, T, H*D)
//     activations go in and out without the head transposes of the JAX path.
// Registers are the constraint: at D = 128 a consumer thread holds O (64
// fp32), S (64) and the previous tile's P (32 bf16 pairs). No branch
// surrounds a wgmma, and the build must report no spill (chip_smoke.py).
//
// C interface, for ctypes: ltx_flash_attention_fwd returns the launch's
// cudaGetLastError() (0 = launched), or cudaErrorInvalidValue for a head
// dimension it was not built for or a tensor TMA cannot address.

#include "flash_common.cuh"
#include "sm90_common.cuh"

namespace {

using namespace ltx_sm90;

constexpr int kBlockM = 128;   // query rows per CTA: two consumer warpgroups x 64
constexpr int kBlockN = 128;   // keys per K/V tile
constexpr int kStages = 2;     // K/V ring depth
constexpr int kThreads = 384;  // producer warpgroup + two consumer warpgroups
constexpr uint32_t kPanel = 128 * 128;     // one 64-column panel of a 128-row tile (Q, K or V)
constexpr uint32_t kHalfPanel = 64 * 128;  // a consumer's 64 rows of a Q panel

// Shared memory layout (byte offsets from a 1024-aligned base).
template <int D>
struct Smem {
  static constexpr uint32_t kTile = kPanel * (D / 64);  // 128 rows x D bf16
  static constexpr uint32_t q = 0;
  static constexpr uint32_t kv = kTile;  // stage s: K at kv + 2 s kTile, V kTile after
  static constexpr uint32_t mask = kv + kStages * 2 * kTile;  // key-valid bits, [kStages][4] uint32
  static constexpr uint32_t bars = mask + kStages * 16;  // q_full, k_full[], v_full[], k_empty[], v_empty[]
  static constexpr uint32_t bytes = bars + (1 + 4 * kStages) * 8 + 1024;  // + alignment slack
};

struct Maps {
  CUtensorMap q, k, v;  // bf16, dims (D, T, H, B), boxes of 64 columns x 128 tokens
  CUtensorMap o;        // bf16, dims (D, T_q, H, B), boxes of 64 columns x 64 tokens
};

struct Params {
  const uint8_t* kv_valid;  // (B, T_k) with batch stride kv_sb, or null
  float* l;                 // (B, H, T_q) softmax row sums, or null
  float* m;                 // (B, H, T_q) row maxima of the scaled logits, or null
  int64_t kv_sb;
  int t_q, t_k;
  float scale;
  float scale_log2;  // scale * log2(e): the softmax runs on exp2
};

// S = Q K^T for a warpgroup's 64 query rows and a tile's 128 keys (K-major
// operands: a 16-deep k-step is 32 bytes inside a 64-column panel).
template <int D>
__device__ __forceinline__ void issue_qk(float (&s)[64], uint32_t s_q, uint32_t s_k) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss_m64n128(s, wgmma_desc(s_q + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024),
                     wgmma_desc(s_k + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024), kk > 0);
  wgmma_commit();
}

// O += P V: P from registers (k-step kk = keys 16 kk .. 16 kk + 15), V read
// MN-major (a k-step is 16 key rows; LBO is the panel stride).
template <int D>
__device__ __forceinline__ void issue_pv(float (&o)[D / 2], const uint32_t (&pa)[kBlockN / 16][4], uint32_t s_v) {
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk) wgmma_rs<D, 1>(o, pa[kk], wgmma_desc(s_v + kk * 2048, kPanel, 1024));
  wgmma_commit();
}

// Scores of keys whose bit is clear (ragged or invalid) become -inf. Column
// 8 j + 2 t4 + e of the tile is bit 8 (j % 4) + 2 t4 + e of word j / 4.
__device__ __forceinline__ void mask_tile(float (&s)[64], const uint32_t (&bits)[4], int t4) {
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 2; ++e)
      if (!((bits[j / 4] >> (8 * (j % 4) + 2 * t4 + e)) & 1u)) s[4 * j + e] = s[4 * j + 2 + e] = -INFINITY;
}

// Online softmax of one tile: the raw scores s become P in place; the running
// max m_i (raw units) and this thread's share of the row sums l_i advance,
// and alpha is the factor that brings O to the new max. Element 4 j + c lies
// in row g + 8 (c / 2); the 4 threads of a quad share each row.
__device__ __forceinline__ void softmax_tile(float (&s)[64], float (&m_i)[2], float (&l_i)[2], float (&alpha)[2],
                                             float scale_log2) {
  float mx[2] = {m_i[0], m_i[1]};
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
  float ms[2], sum[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    ms[i] = (mx[i] == -INFINITY ? 0.f : mx[i]) * scale_log2;  // a row with no valid key yet: m = 0
    alpha[i] = exp2_approx(m_i[i] * scale_log2 - ms[i]);       // 0 while m_i is -inf
    m_i[i] = mx[i];
  }
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      s[4 * j + c] = exp2_approx(fmaf(s[4 * j + c], scale_log2, -ms[c / 2]));
      sum[c / 2] += s[4 * j + c];
    }
#pragma unroll
  for (int i = 0; i < 2; ++i) l_i[i] = l_i[i] * alpha[i] + sum[i];
}

__device__ __forceinline__ void to_bf16_operand(uint32_t (&pa)[kBlockN / 16][4], const float (&s)[64]) {
#pragma unroll
  for (int kk = 0; kk < kBlockN / 16; ++kk)
#pragma unroll
    for (int i = 0; i < 4; ++i) pa[kk][i] = pack_bf16x2(s[8 * kk + 2 * i], s[8 * kk + 2 * i + 1]);
}

template <int D>
__device__ __forceinline__ void rescale(float (&o)[D / 2], const float (&alpha)[2]) {
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] *= alpha[(i / 2) % 2];
}

template <int D>
__global__ void __launch_bounds__(kThreads, 1) flash_fwd_kernel(const __grid_constant__ Maps maps, const Params p) {
  using L = Smem<D>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (ltx_flash::smem_addr(smem_raw) + 1023) & ~1023u;
  uint32_t* s_mask = reinterpret_cast<uint32_t*>(smem_raw + (base - ltx_flash::smem_addr(smem_raw)) + L::mask);
  const uint32_t bar_q = base + L::bars;
  const uint32_t bar_kfull = bar_q + 8;  // + 8 s
  const uint32_t bar_vfull = bar_kfull + 8 * kStages;
  const uint32_t bar_kempty = bar_vfull + 8 * kStages;
  const uint32_t bar_vempty = bar_kempty + 8 * kStages;

  const int m0 = blockIdx.x * kBlockM, h = blockIdx.y, b = blockIdx.z;
  const int n_tiles = (p.t_k + kBlockN - 1) / kBlockN;
  const int wg = threadIdx.x / 128;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(bar_kfull + 8 * s, 1);
      mbar_init(bar_vfull + 8 * s, 1);
      mbar_init(bar_kempty + 8 * s, 2 * 128);
      mbar_init(bar_vempty + 8 * s, 2 * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (wg == 0) {
    // ---- producer ----
    warpgroup_reg_dealloc<24>();
    if (threadIdx.x < 32) {
      const int lane = threadIdx.x;
      const uint8_t* valid = p.kv_valid != nullptr ? p.kv_valid + b * p.kv_sb : nullptr;
      if (lane == 0) {
        prefetch_tensor_map(&maps.k);
        prefetch_tensor_map(&maps.v);
        mbar_arrive_expect_tx(bar_q, L::kTile);
        for (int c = 0; c < D / 64; ++c) tma_load_4d(base + L::q + c * kPanel, &maps.q, bar_q, 64 * c, m0, h, b);
      }
      for (int j = 0; j < n_tiles; ++j) {
        const int st = j % kStages;
        const uint32_t parity = ((j / kStages) & 1) ^ 1;
        const uint32_t s_k = base + L::kv + st * 2 * L::kTile;
        mbar_wait(bar_kempty + 8 * st, parity);
        // Bit i of word w: key j * 128 + 32 w + i is in range and valid.
#pragma unroll
        for (int w = 0; w < 4; ++w) {
          const int key = j * kBlockN + 32 * w + lane;
          const uint32_t bits = __ballot_sync(0xffffffffu, key < p.t_k && (valid == nullptr || valid[key] != 0));
          if (lane == w) s_mask[st * 4 + w] = bits;
        }
        __syncwarp();
        if (lane == 0) {
          mbar_arrive_expect_tx(bar_kfull + 8 * st, L::kTile);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(s_k + c * kPanel, &maps.k, bar_kfull + 8 * st, 64 * c, j * kBlockN, h, b);
        }
        mbar_wait(bar_vempty + 8 * st, parity);
        if (lane == 0) {
          mbar_arrive_expect_tx(bar_vfull + 8 * st, L::kTile);
          for (int c = 0; c < D / 64; ++c)
            tma_load_4d(s_k + L::kTile + c * kPanel, &maps.v, bar_vfull + 8 * st, 64 * c, j * kBlockN, h, b);
        }
      }
    }
  } else {
    // ---- consumers ----
    warpgroup_reg_alloc<240>();
    const int cw = wg - 1;  // this warpgroup owns query rows m0 + 64 cw .. + 63
    const int tid = threadIdx.x % 128, warp = tid / 32, lane = tid % 32;
    const int g = lane / 4, t4 = lane % 4;
    const bool has_valid = p.kv_valid != nullptr;

    float o[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
    float m_i[2] = {-INFINITY, -INFINITY};
    float l_i[2] = {0.f, 0.f};  // this thread's share of the row sums
    float alpha[2];
    float s[64];
    uint32_t pa[kBlockN / 16][4];

    mbar_wait(bar_q, 0);
    // Turns to issue products: warpgroup cw waits at barrier 3 + cw, then
    // arrives at the other's; the second warpgroup lets the first go first.
    const int my_turn = 3 + cw, their_turn = 4 - cw;
    if (cw == 1) named_barrier_arrive(3, 256);

    // Tile 0: S, softmax, P.
    mbar_wait(bar_kfull, 0);
    named_barrier_sync(my_turn, 256);
    issue_qk<D>(s, base + L::q + cw * kHalfPanel, base + L::kv);
    named_barrier_arrive(their_turn, 256);
    fence_regs(s);
    wgmma_wait<0>();
    fence_regs(s);
    {
      const bool need_mask = has_valid || kBlockN > p.t_k;
      uint32_t bits[4] = {~0u, ~0u, ~0u, ~0u};
      if (need_mask) {
#pragma unroll
        for (int w = 0; w < 4; ++w) bits[w] = s_mask[w];
      }
      mbar_arrive(bar_kempty);
      if (need_mask) mask_tile(s, bits, t4);
    }
    softmax_tile(s, m_i, l_i, alpha, p.scale_log2);
    to_bf16_operand(pa, s);

    // Tile j: S_j and P_{j-1} V_{j-1} issued together; the softmax of S_j
    // runs while P V is on the tensor cores.
    for (int j = 1; j < n_tiles; ++j) {
      const int st = j % kStages, pst = (j - 1) % kStages;
      // Addresses are rebuilt every tile from an opaque base: hoisted out of
      // the loop, they would hold registers the accumulators need.
      const uint32_t tile = opaque(base);
      mbar_wait(bar_kfull + 8 * st, (j / kStages) & 1);
      named_barrier_sync(my_turn, 256);
      issue_qk<D>(s, tile + L::q + cw * kHalfPanel, tile + L::kv + st * 2 * L::kTile);
      fence_regs(s);
      rescale<D>(o, alpha);
      mbar_wait(bar_vfull + 8 * pst, ((j - 1) / kStages) & 1);
      issue_pv<D>(o, pa, tile + L::kv + pst * 2 * L::kTile + L::kTile);
      named_barrier_arrive(their_turn, 256);
      fence_regs(o);
      fence_regs(pa);
      wgmma_wait<1>();  // S_j is done, P V may still run
      fence_regs(s);
      const bool need_mask = has_valid || (j + 1) * kBlockN > p.t_k;
      uint32_t bits[4] = {~0u, ~0u, ~0u, ~0u};
      if (need_mask) {
#pragma unroll
        for (int w = 0; w < 4; ++w) bits[w] = s_mask[st * 4 + w];
      }
      mbar_arrive(bar_kempty + 8 * st);  // the bits are read: the K stage may be refilled
      if (need_mask) mask_tile(s, bits, t4);
      softmax_tile(s, m_i, l_i, alpha, p.scale_log2);
      wgmma_wait<0>();
      fence_regs(o);
      fence_regs(pa);
      mbar_arrive(bar_vempty + 8 * pst);
      to_bf16_operand(pa, s);
    }

    // The last tile's P V.
    {
      const int lst = (n_tiles - 1) % kStages;
      rescale<D>(o, alpha);
      mbar_wait(bar_vfull + 8 * lst, ((n_tiles - 1) / kStages) & 1);
      named_barrier_sync(my_turn, 256);
      issue_pv<D>(o, pa, base + L::kv + lst * 2 * L::kTile + L::kTile);
      if (cw == 0) named_barrier_arrive(their_turn, 256);  // the second's last turn needs no answer
      fence_regs(o);
      fence_regs(pa);
      wgmma_wait<0>();
      fence_regs(o);
    }

    // Epilogue: O / l as bf16 into this warpgroup's rows of the Q tile (no
    // product reads them any more; 128-byte swizzle, as TMA reads them), then
    // TMA stores, which drop rows past T_q.
    float l_row[2], inv[2];
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float l = l_i[i];
      l += __shfl_xor_sync(0xffffffffu, l, 1);
      l += __shfl_xor_sync(0xffffffffu, l, 2);
      l_row[i] = l;
      inv[i] = l > 0.f ? 1.f / l : 0.f;
    }
    const uint32_t s_o = base + L::q + cw * kHalfPanel;
#pragma unroll
    for (int jd = 0; jd < D / 8; ++jd)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = 16 * warp + g + 8 * i;
        st_shared_b32(s_o + (jd / 8) * kPanel + r * 128 + (((jd % 8) ^ (r & 7)) << 4) + t4 * 4,
                      pack_bf16x2(o[4 * jd + 2 * i] * inv[i], o[4 * jd + 2 * i + 1] * inv[i]));
      }
    fence_proxy_async();
    named_barrier_sync(1 + cw, 128);
    const int row0 = m0 + 64 * cw;
    if (tid == 0 && row0 < p.t_q) {
      for (int c = 0; c < D / 64; ++c) tma_store_4d(&maps.o, s_o + c * kPanel, 64 * c, row0, h, b);
      bulk_commit();
    }
    // Residuals for the backward, in Pallas's convention: m in units of the
    // scaled logits, l = sum exp(s - m) after the last rescale.
    if (p.l != nullptr && t4 == 0) {
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int row = row0 + 16 * warp + g + 8 * i;
        if (row < p.t_q) {
          const int64_t at = (int64_t(b) * gridDim.y + h) * p.t_q + row;
          p.l[at] = l_row[i];
          p.m[at] = m_i[i] * p.scale;
        }
      }
    }
    if (tid == 0) bulk_wait_read();  // the staging stays until the stores have read it
  }
}

// Tensor map of a bf16 (B, H, T, D) tensor with (batch, token, head)
// element strides, in boxes of `rows` tokens x 64 columns.
bool bf16_map(CUtensorMap* map, const void* ptr, int batch, int heads, int t, int d, int64_t sb, int64_t st,
              int64_t sh, int rows) {
  const uint64_t dims[4] = {uint64_t(d), uint64_t(t), uint64_t(heads), uint64_t(batch)};
  const uint64_t strides[3] = {uint64_t(st) * 2, uint64_t(sh) * 2, uint64_t(sb) * 2};
  const uint32_t box[4] = {64, uint32_t(rows), 1, 1};
  return encode_tensor_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims, strides, box);
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Params& p, int batch, int heads,
                   const int64_t (&s)[12], cudaStream_t stream) {
  Maps maps;
  if (!bf16_map(&maps.q, q, batch, heads, p.t_q, D, s[0], s[1], s[2], kBlockM) ||
      !bf16_map(&maps.k, k, batch, heads, p.t_k, D, s[3], s[4], s[5], kBlockN) ||
      !bf16_map(&maps.v, v, batch, heads, p.t_k, D, s[6], s[7], s[8], kBlockN) ||
      !bf16_map(&maps.o, o, batch, heads, p.t_q, D, s[9], s[10], s[11], kBlockM / 2))
    return cudaErrorInvalidValue;
  constexpr int kSmem = Smem<D>::bytes;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_q + kBlockM - 1) / kBlockM, heads, batch);  // the query tiles of one head run together
  flash_fwd_kernel<D><<<grid, kThreads, kSmem, stream>>>(maps, p);
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
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.l = static_cast<float*>(l);
  p.m = static_cast<float*>(m);
  p.kv_sb = kv_sb;
  p.t_q = t_q;
  p.t_k = t_k;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  const int64_t strides[12] = {q_sb, q_st, q_sh, k_sb, k_st, k_sh, v_sb, v_st, v_sh, o_sb, o_st, o_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return static_cast<int>(launch<128>(q, k, v, o, p, batch, heads, strides, s));
  if (head_dim == 64) return static_cast<int>(launch<64>(q, k, v, o, p, batch, heads, strides, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
