// Flash-attention backward for Hopper (sm_90a): dQ, dK and dV of non-causal
// O = softmax(Q K^T * scale) V, bf16 operands and gradients, fp32 scores,
// probabilities and accumulators, with the optional key-valid mask (B, T_k)
// of the forward.
//
// Replaces the Pallas TPU backward that the custom VJP of the upstream
// flash attention reaches from ltx2_tpu/ops/attention.py (`_flash_attention`
// :188 and `_flash_attention_masked` :222, made differentiable by
// `_full_block_sizes` :165): `_flash_attention_bwd_dkv` and
// `_flash_attention_bwd_dq` of jax/experimental/pallas/ops/tpu/
// flash_attention.py. As there, the work is split into two kernels, and the
// probabilities are recomputed from the forward's residuals instead of being
// stored: P = exp(S - m) / l, dP = dO V^T, dS = P * (dP - Di) with
// Di = rowsum(dO * O) (computed by the caller, as upstream does outside its
// kernels), dV = P^T dO, dK = dS^T Q * scale, dQ = dS K * scale.
//   - dkv kernel: one block owns 64 keys of one (batch, head) and walks every
//     query tile, so dK and dV accumulate in registers and are written once;
//   - dq kernel: one block owns 128 query rows and walks every key tile, the
//     forward's loop order, so dQ is written once.
// Neither kernel uses atomics, so the gradients are deterministic.
//
// Bound on an H100 SXM at the DiT's video self-attention (B=1, H=32,
// T=6144, D=128): five products of 2*H*T^2*D FLOP each (S and dP in both
// kernels count once: the dq kernel recomputes them, which is not in the
// bound) = 1.55e12 FLOP, 1.56 ms at 989 TFLOP/s, against about 350 MB of
// Q/K/V/O/dO/dQ/dK/dV traffic, 0.1 ms at 3.35 TB/s: compute-bound. So every
// product runs on the tensor cores (mma.sync m16n8k16, bf16 in, fp32
// accumulate); P and dS live in registers and are rounded to bf16 only as
// the A operand of the next product (the accumulator fragment of one product
// is the A fragment of the next); Q/dO (dkv) and K/V (dq) tiles are
// double-buffered with cp.async in XOR-swizzled shared memory. Any T_q, T_k:
// ragged tiles are zero-filled, padded queries get P = 0 through an infinite
// normaliser, padded and invalid keys through a zero P. Tensors are addressed
// through (batch, token, head) strides, so the DiT's token-major activations
// go in and the gradients come out without transposes. Left for later work,
// as for the forward: wgmma + TMA with warp specialisation.
//
// C interface, for ctypes: ltx_flash_attention_bwd_dkv / _dq launch one
// kernel each and return the launch's cudaGetLastError() (0 = launched), or
// cudaErrorInvalidValue for a head dimension they were not built for.

#include "flash_common.cuh"

namespace {

using namespace ltx_flash;

constexpr int kDkvKeys = 64;  // keys per dkv block: 4 warps x 16 rows
constexpr int kDkvQ = 64;     // queries per dkv tile
constexpr int kDkvThreads = kDkvKeys / 16 * 32;
constexpr int kDqRows = 128;  // query rows per dq block: 8 warps x 16 rows
constexpr int kDqKeys = 64;   // keys per dq tile
constexpr int kDqThreads = kDqRows / 16 * 32;

struct BwdParams {
  const __nv_bfloat16* q;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* dout;
  __nv_bfloat16* dq;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  const float* l;   // (B, H, T_q) forward residuals
  const float* m;
  const float* di;  // (B, H, T_q) rowsum(dO * O)
  const uint8_t* kv_valid;  // (B, T_k) with batch stride kv_sb, or null
  int64_t q_sb, q_st, q_sh;
  int64_t k_sb, k_st, k_sh;
  int64_t v_sb, v_st, v_sh;
  int64_t do_sb, do_st, do_sh;
  int64_t dq_sb, dq_st, dq_sh;
  int64_t dk_sb, dk_st, dk_sh;
  int64_t dv_sb, dv_st, dv_sh;
  int64_t kv_sb;
  int t_q, t_k;
  float scale;       // softmax scale: dQ and dK carry it
  float scale_log2;  // scale * log2(e)
};

// Store a warp's 16 x D fp32 accumulator rows (row0 + g, row0 + g + 8) as
// bf16, times `mul`, skipping rows at or past `rows`.
template <int D>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, int64_t stride, int row0, int rows,
                                           const float (&acc)[D / 8][4], float mul, int lane) {
  const int g = lane / 4, t4 = lane % 4;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= rows) continue;
    __nv_bfloat16* dst = base + int64_t(row) * stride + 2 * t4;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(dst + nt * 8) =
          __floats2bfloat162_rn(acc[nt][2 * i] * mul, acc[nt][2 * i + 1] * mul);
  }
}

template <int D>
__global__ void __launch_bounds__(kDkvThreads, 1) flash_bwd_dkv_kernel(const BwdParams p) {
  constexpr uint32_t kTileK = kDkvKeys * D * 2;
  constexpr uint32_t kTileQ = kDkvQ * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ float s_lse[2][kDkvQ];  // per query of the staged tile: log2 normaliser
  __shared__ float s_di[2][kDkvQ];   // and Di
  const uint32_t s_k = smem_addr(smem);
  const uint32_t s_v = s_k + kTileK;
  const uint32_t s_qdo = s_v + kTileK;  // stage s: Q at s_qdo + 2*s*kTileQ, dO right after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int n0 = blockIdx.x * kDkvKeys, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16;

  const __nv_bfloat16* q = p.q + b * p.q_sb + h * p.q_sh;
  const __nv_bfloat16* dout = p.dout + b * p.do_sb + h * p.do_sh;
  const int64_t stats = (int64_t(b) * gridDim.y + h) * p.t_q;
  const float* l = p.l + stats;
  const float* m = p.m + stats;
  const float* di = p.di + stats;

  // This thread's two key rows; a padded or invalid key has P = 0, so its
  // dK and dV rows stay 0.
  bool key_ok[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = n0 + wrow + g + 8 * i;
    key_ok[i] = key < p.t_k && (p.kv_valid == nullptr || p.kv_valid[b * p.kv_sb + key] != 0);
  }

  load_tile<D, kDkvKeys, kDkvThreads>(s_k, p.k + b * p.k_sb + h * p.k_sh + int64_t(n0) * p.k_st,
                                      p.k_st, p.t_k - n0, tid);
  load_tile<D, kDkvKeys, kDkvThreads>(s_v, p.v + b * p.v_sb + h * p.v_sh + int64_t(n0) * p.v_st,
                                      p.v_st, p.t_k - n0, tid);
  load_tile<D, kDkvQ, kDkvThreads>(s_qdo, q, p.q_st, p.t_q, tid);
  load_tile<D, kDkvQ, kDkvThreads>(s_qdo + kTileQ, dout, p.do_st, p.t_q, tid);
  cp_async_commit();
  if (tid < kDkvQ) {
    const bool ok = tid < p.t_q;
    s_lse[0][tid] = ok ? row_lse2(l[tid], m[tid]) : INFINITY;
    s_di[0][tid] = ok ? di[tid] : 0.f;
  }

  float dk[D / 8][4], dv[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[nt][e] = dv[nt][e] = 0.f;

  const int n_tiles = (p.t_q + kDkvQ - 1) / kDkvQ;
  for (int j = 0; j < n_tiles; ++j) {
    const int st = j & 1;
    const uint32_t s_q = s_qdo + st * 2 * kTileQ;
    const uint32_t s_do = s_q + kTileQ;
    if (j + 1 < n_tiles) {
      const int q1 = (j + 1) * kDkvQ;
      const uint32_t nq = s_qdo + (st ^ 1) * 2 * kTileQ;
      load_tile<D, kDkvQ, kDkvThreads>(nq, q + int64_t(q1) * p.q_st, p.q_st, p.t_q - q1, tid);
      load_tile<D, kDkvQ, kDkvThreads>(nq + kTileQ, dout + int64_t(q1) * p.do_st, p.do_st,
                                       p.t_q - q1, tid);
      cp_async_commit();
      if (tid < kDkvQ) {
        const int r = q1 + tid;
        const bool ok = r < p.t_q;
        s_lse[st ^ 1][tid] = ok ? row_lse2(l[r], m[r]) : INFINITY;
        s_di[st ^ 1][tid] = ok ? di[r] : 0.f;
      }
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // P^T = exp2(K Q^T * scale * log2(e) - lse2[query]): this warp's 16 keys
    // x 64 queries. A padded query has lse2 = +inf, so its column is 0.
    float pt[kDkvQ / 8][4];
#pragma unroll
    for (int jn = 0; jn < kDkvQ / 8; ++jn) pt[jn][0] = pt[jn][1] = pt[jn][2] = pt[jn][3] = 0.f;
    mma_abt<D, kDkvQ>(pt, s_k, wrow, s_q, 0, lane);
#pragma unroll
    for (int jn = 0; jn < kDkvQ / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jn * 8 + 2 * t4 + (e & 1);
        pt[jn][e] = key_ok[e >> 1] ? exp2f(pt[jn][e] * p.scale_log2 - s_lse[st][col]) : 0.f;
      }

    // dV += P^T dO.
    mma_pb<D, kDkvQ>(dv, pt, s_do, 0, lane);

    // dS^T = P^T * (V dO^T - Di[query]), in place of dP^T.
    float ds[kDkvQ / 8][4];
#pragma unroll
    for (int jn = 0; jn < kDkvQ / 8; ++jn) ds[jn][0] = ds[jn][1] = ds[jn][2] = ds[jn][3] = 0.f;
    mma_abt<D, kDkvQ>(ds, s_v, wrow, s_do, 0, lane);
#pragma unroll
    for (int jn = 0; jn < kDkvQ / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = jn * 8 + 2 * t4 + (e & 1);
        ds[jn][e] = pt[jn][e] * (ds[jn][e] - s_di[st][col]);
      }

    // dK += dS^T Q (the scale is applied once, at the store).
    mma_pb<D, kDkvQ>(dk, ds, s_q, 0, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  const int rows = p.t_k - n0;
  store_rows<D>(p.dk + b * p.dk_sb + h * p.dk_sh + int64_t(n0) * p.dk_st, p.dk_st, wrow, rows, dk,
                p.scale, lane);
  store_rows<D>(p.dv + b * p.dv_sb + h * p.dv_sh + int64_t(n0) * p.dv_st, p.dv_st, wrow, rows, dv,
                1.f, lane);
}

template <int D>
__global__ void __launch_bounds__(kDqThreads, 1) flash_bwd_dq_kernel(const BwdParams p) {
  constexpr uint32_t kTileQ = kDqRows * D * 2;
  constexpr uint32_t kTileKV = kDqKeys * D * 2;
  extern __shared__ __align__(128) unsigned char smem[];
  const uint32_t s_q = smem_addr(smem);
  const uint32_t s_do = s_q + kTileQ;
  const uint32_t s_kv = s_do + kTileQ;  // stage s: K at s_kv + 2*s*kTileKV, V right after

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int g = lane / 4, t4 = lane % 4;
  const int m0 = blockIdx.x * kDqRows, h = blockIdx.y, b = blockIdx.z;
  const int wrow = warp * 16;

  const __nv_bfloat16* k = p.k + b * p.k_sb + h * p.k_sh;
  const __nv_bfloat16* v = p.v + b * p.v_sb + h * p.v_sh;
  const uint8_t* valid = p.kv_valid ? p.kv_valid + b * p.kv_sb : nullptr;
  const int64_t stats = (int64_t(b) * gridDim.y + h) * p.t_q;

  load_tile<D, kDqRows, kDqThreads>(s_q, p.q + b * p.q_sb + h * p.q_sh + int64_t(m0) * p.q_st,
                                    p.q_st, p.t_q - m0, tid);
  load_tile<D, kDqRows, kDqThreads>(s_do, p.dout + b * p.do_sb + h * p.do_sh + int64_t(m0) * p.do_st,
                                    p.do_st, p.t_q - m0, tid);
  load_tile<D, kDqKeys, kDqThreads>(s_kv, k, p.k_st, p.t_k, tid);
  load_tile<D, kDqKeys, kDqThreads>(s_kv + kTileKV, v, p.v_st, p.t_k, tid);
  cp_async_commit();

  // This thread's two query rows: log2 normaliser and Di. A padded row gets
  // lse2 = +inf (P = 0) and is never stored.
  float lse2[2], di[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = m0 + wrow + g + 8 * i;
    const bool ok = row < p.t_q;
    lse2[i] = ok ? row_lse2(p.l[stats + row], p.m[stats + row]) : INFINITY;
    di[i] = ok ? p.di[stats + row] : 0.f;
  }

  float dq[D / 8][4];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) dq[nt][0] = dq[nt][1] = dq[nt][2] = dq[nt][3] = 0.f;

  const int n_tiles = (p.t_k + kDqKeys - 1) / kDqKeys;
  for (int j = 0; j < n_tiles; ++j) {
    const int n0 = j * kDqKeys;
    const uint32_t s_k = s_kv + (j & 1) * 2 * kTileKV;
    const uint32_t s_v = s_k + kTileKV;
    if (j + 1 < n_tiles) {
      const uint32_t nk = s_kv + ((j + 1) & 1) * 2 * kTileKV;
      const int n1 = n0 + kDqKeys;
      load_tile<D, kDqKeys, kDqThreads>(nk, k + int64_t(n1) * p.k_st, p.k_st, p.t_k - n1, tid);
      load_tile<D, kDqKeys, kDqThreads>(nk + kTileKV, v + int64_t(n1) * p.v_st, p.v_st, p.t_k - n1,
                                        tid);
      cp_async_commit();
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    // P = exp2(Q K^T * scale * log2(e) - lse2[row]): this warp's 16 rows x
    // 64 keys; padded and invalid keys get 0.
    float pr[kDqKeys / 8][4];
#pragma unroll
    for (int jn = 0; jn < kDqKeys / 8; ++jn) pr[jn][0] = pr[jn][1] = pr[jn][2] = pr[jn][3] = 0.f;
    mma_abt<D, kDqKeys>(pr, s_q, wrow, s_k, 0, lane);
    const bool edge = n0 + kDqKeys > p.t_k || valid != nullptr;
#pragma unroll
    for (int jn = 0; jn < kDqKeys / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = n0 + jn * 8 + 2 * t4 + (e & 1);
        const bool ok = !edge || (col < p.t_k && (valid == nullptr || valid[col] != 0));
        pr[jn][e] = ok ? exp2f(pr[jn][e] * p.scale_log2 - lse2[e >> 1]) : 0.f;
      }

    // dS = P * (dO V^T - Di[row]).
    float ds[kDqKeys / 8][4];
#pragma unroll
    for (int jn = 0; jn < kDqKeys / 8; ++jn) ds[jn][0] = ds[jn][1] = ds[jn][2] = ds[jn][3] = 0.f;
    mma_abt<D, kDqKeys>(ds, s_do, wrow, s_v, 0, lane);
#pragma unroll
    for (int jn = 0; jn < kDqKeys / 8; ++jn)
#pragma unroll
      for (int e = 0; e < 4; ++e) ds[jn][e] = pr[jn][e] * (ds[jn][e] - di[e >> 1]);

    // dQ += dS K (the scale is applied once, at the store).
    mma_pb<D, kDqKeys>(dq, ds, s_k, 0, lane);
    __syncthreads();  // every warp is done with this stage before it is refilled
  }

  store_rows<D>(p.dq + b * p.dq_sb + h * p.dq_sh + int64_t(m0) * p.dq_st, p.dq_st, wrow,
                p.t_q - m0, dq, p.scale, lane);
}

template <int D>
cudaError_t launch_dkv(const BwdParams& p, int batch, int heads, cudaStream_t stream) {
  constexpr int kSmem = 2 * kDkvKeys * D * 2 + 4 * kDkvQ * D * 2;  // K, V + 2 stages of Q and dO
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dkv_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_k + kDkvKeys - 1) / kDkvKeys, heads, batch);
  flash_bwd_dkv_kernel<D><<<grid, kDkvThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_dq(const BwdParams& p, int batch, int heads, cudaStream_t stream) {
  constexpr int kSmem = 2 * kDqRows * D * 2 + 4 * kDqKeys * D * 2;  // Q, dO + 2 stages of K and V
  cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.t_q + kDqRows - 1) / kDqRows, heads, batch);
  flash_bwd_dq_kernel<D><<<grid, kDqThreads, kSmem, stream>>>(p);
  return cudaGetLastError();
}

BwdParams make_params(const void* q, const void* k, const void* v, const void* dout, void* dq,
                      void* dk, void* dv, const void* l, const void* m, const void* di,
                      const void* kv_valid, int t_q, int t_k, const int64_t* s, float scale) {
  BwdParams p;
  p.q = static_cast<const __nv_bfloat16*>(q);
  p.k = static_cast<const __nv_bfloat16*>(k);
  p.v = static_cast<const __nv_bfloat16*>(v);
  p.dout = static_cast<const __nv_bfloat16*>(dout);
  p.dq = static_cast<__nv_bfloat16*>(dq);
  p.dk = static_cast<__nv_bfloat16*>(dk);
  p.dv = static_cast<__nv_bfloat16*>(dv);
  p.l = static_cast<const float*>(l);
  p.m = static_cast<const float*>(m);
  p.di = static_cast<const float*>(di);
  p.kv_valid = static_cast<const uint8_t*>(kv_valid);
  p.q_sb = s[0]; p.q_st = s[1]; p.q_sh = s[2];
  p.k_sb = s[3]; p.k_st = s[4]; p.k_sh = s[5];
  p.v_sb = s[6]; p.v_st = s[7]; p.v_sh = s[8];
  p.do_sb = s[9]; p.do_st = s[10]; p.do_sh = s[11];
  p.dq_sb = s[12]; p.dq_st = s[13]; p.dq_sh = s[14];
  p.dk_sb = s[15]; p.dk_st = s[16]; p.dk_sh = s[17];
  p.dv_sb = s[18]; p.dv_st = s[19]; p.dv_sh = s[20];
  p.kv_sb = s[21];
  p.t_q = t_q;
  p.t_k = t_k;
  p.scale = scale;
  p.scale_log2 = scale * 1.4426950408889634f;
  return p;
}

}  // namespace

// strides: 22 int64 = (batch, token, head) strides of q, k, v, dO, dQ, dK, dV
// in elements, then the batch stride of kv_valid.
extern "C" int ltx_flash_attention_bwd_dkv(const void* q, const void* k, const void* v,
                                           const void* dout, void* dq, void* dk, void* dv,
                                           const void* l, const void* m, const void* di,
                                           const void* kv_valid, int batch, int heads, int t_q,
                                           int t_k, int head_dim, const int64_t* strides,
                                           float scale, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, dq, dk, dv, l, m, di, kv_valid, t_q, t_k, strides,
                                  scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return static_cast<int>(launch_dkv<128>(p, batch, heads, s));
  if (head_dim == 64) return static_cast<int>(launch_dkv<64>(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" int ltx_flash_attention_bwd_dq(const void* q, const void* k, const void* v,
                                          const void* dout, void* dq, void* dk, void* dv,
                                          const void* l, const void* m, const void* di,
                                          const void* kv_valid, int batch, int heads, int t_q,
                                          int t_k, int head_dim, const int64_t* strides,
                                          float scale, void* stream) {
  const BwdParams p = make_params(q, k, v, dout, dq, dk, dv, l, m, di, kv_valid, t_q, t_k, strides,
                                  scale);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (head_dim == 128) return static_cast<int>(launch_dq<128>(p, batch, heads, s));
  if (head_dim == 64) return static_cast<int>(launch_dq<64>(p, batch, heads, s));
  return static_cast<int>(cudaErrorInvalidValue);
}
