// Helpers shared by the port's kernels that predate sm90_common.cuh:
// cp.async 16-byte copies into shared memory (the fp32 conv's tile loads and
// the bf16 conv's gather, conv3d.cu), shared-memory addresses, and the
// softmax normaliser convention (`row_lse2`) the backward
// (flash_attention_bwd.cu) reads the forward's residuals with.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace ltx_flash {

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
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

// log2 of the softmax normaliser of one query row, from the forward's
// residuals in Pallas's convention (m = row max of the scaled logits,
// l = sum exp(s - m)): P = exp2(s * scale * log2(e) - lse2). A row with no
// valid key (l = 0) gets +inf, so its P is exactly 0.
__device__ __forceinline__ float row_lse2(float l, float m) {
  return l > 0.f ? m * 1.4426950408889634f + log2f(l) : INFINITY;
}

}  // namespace ltx_flash
