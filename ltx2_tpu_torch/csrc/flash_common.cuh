// Device helpers of the mma.sync kernels for Hopper (sm_90a), the
// flash-attention forward (flash_attention.cu) and the conv (conv3d.cu):
// cp.async tile loads into XOR-swizzled shared memory, ldmatrix, and the
// mma.sync m16n8k16 bf16 product with fp32 accumulation; and the softmax
// normaliser convention (`row_lse2`) the backward (flash_attention_bwd.cu,
// built on sm90_common.cuh) reads the forward's residuals with.
//
// Fragment conventions of mma.sync.m16n8k16 used by both files: an fp32
// accumulator tile of 16 rows x 8 columns holds, in lane (g = lane / 4,
// t4 = lane % 4), the elements (g, 2*t4 + e) in c[e] and (g + 8, 2*t4 + e) in
// c[2 + e], e = 0, 1. Two adjacent accumulator tiles, rounded to bf16, form
// one 16x16 A operand (`acc_to_a`), so a product's output feeds the next
// product without passing through shared memory.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ltx_flash {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of 16-byte chunk `c` of row `r` in a tile of kChunks chunks a
// row. The chunk index is XORed with (r % 8): the 8 rows one ldmatrix phase
// reads then sit in 8 different bank groups.
template <int kChunks>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return static_cast<uint32_t>((r * kChunks + (c ^ (r & 7))) * 16);
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool pred) {
  const int n = pred ? 16 : 0;  // 0 source bytes: the chunk is zero-filled
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(addr)
               : "memory");
}

// c += A (16x16, row-major fragment) * B (16x8, column-major fragment).
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // lo in the low 16 bits
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator n-tiles 2*kk and 2*kk + 1 (16 rows x 16 columns) as the bf16 A
// operand of a product whose reduction runs over those 16 columns.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&lo)[4],
                                         const float (&hi)[4]) {
  a[0] = pack_bf16(lo[0], lo[1]);
  a[1] = pack_bf16(lo[2], lo[3]);
  a[2] = pack_bf16(hi[0], hi[1]);
  a[3] = pack_bf16(hi[2], hi[3]);
}

// Copy ROWS rows of D bf16 values (row stride `stride` elements) into a
// swizzled shared tile with THREADS threads; rows at or past `valid` are
// zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile(uint32_t tile, const __nv_bfloat16* g, int64_t stride,
                                          int valid, int tid) {
  constexpr int kChunks = D / 8;
  static_assert((ROWS * kChunks) % THREADS == 0, "tile must split evenly over the block");
#pragma unroll
  for (int it = 0; it < ROWS * kChunks / THREADS; ++it) {
    const int i = it * THREADS + tid;
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < valid;
    cp_async16(tile + swz<kChunks>(r, c), ok ? g + r * stride + c * 8 : g, ok);
  }
}

// S (+)= A B^T for one warp: A is 16 rows of a swizzled [rows][D] tile
// starting at row `a_row`, B is N rows of a swizzled [rows][D] tile starting
// at row `b_row`; acc holds N/8 accumulator n-tiles.
template <int D, int N>
__device__ __forceinline__ void mma_abt(float (&acc)[N / 8][4], uint32_t s_a, int a_row,
                                        uint32_t s_b, int b_row, int lane) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    ldmatrix_x4(a, s_a + swz<kChunks>(a_row + (lane % 16), kk * 2 + lane / 16));
#pragma unroll
    for (int np = 0; np < N / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4(b, s_b + swz<kChunks>(b_row + np * 16 + (lane % 8) + 8 * (lane / 16),
                                         kk * 2 + (lane / 8) % 2));
      mma_bf16(acc[2 * np], a, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], a, b[2], b[3]);
    }
  }
}

// O += P B for one warp: P is the warp's 16 x K accumulator (K/8 n-tiles,
// rounded to bf16 here), B a swizzled [K rows][D] tile starting at row
// `b_row`, read transposed; o holds D/8 accumulator n-tiles.
template <int D, int K>
__device__ __forceinline__ void mma_pb(float (&o)[D / 8][4], const float (&p)[K / 8][4],
                                       uint32_t s_b, int b_row, int lane) {
  constexpr int kChunks = D / 8;
#pragma unroll
  for (int kk = 0; kk < K / 16; ++kk) {
    uint32_t a[4];
    acc_to_a(a, p[2 * kk], p[2 * kk + 1]);
#pragma unroll
    for (int dp = 0; dp < D / 16; ++dp) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, s_b + swz<kChunks>(b_row + kk * 16 + (lane % 8) + 8 * ((lane / 8) % 2),
                                               dp * 2 + lane / 16));
      mma_bf16(o[2 * dp], a, b[0], b[1]);
      mma_bf16(o[2 * dp + 1], a, b[2], b[3]);
    }
  }
}

// log2 of the softmax normaliser of one query row, from the forward's
// residuals in Pallas's convention (m = row max of the scaled logits,
// l = sum exp(s - m)): P = exp2(s * scale * log2(e) - lse2). A row with no
// valid key (l = 0) gets +inf, so its P is exactly 0.
__device__ __forceinline__ float row_lse2(float l, float m) {
  return l > 0.f ? m * 1.4426950408889634f + log2f(l) : INFINITY;
}

}  // namespace ltx_flash
