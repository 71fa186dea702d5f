// The cp.async copies of the fp32 FMA bodies of K1 and K6 (conv_gemm.cuh,
// conv_frontend_bwd.cu), and the bf16 packing of the attention kernels'
// register operands. The bf16 kernels run on wgmma fed by TMA (hopper.cuh).
//
// The fragment layout of an m16n8k16 product (lane = 4 g + t4), which is,
// per warp, the layout of a wgmma accumulator and of its A from registers:
//   A (16 x 16, row-major): a0 = (g, 2t4..2t4+1), a1 = (g+8, 2t4..),
//     a2 = (g, 2t4+8..), a3 = (g+8, 2t4+8..), two bf16 per register;
//   C (16 x 8, fp32):       c0, c1 = (g, 2t4..2t4+1), c2, c3 = (g+8, 2t4..).
// So the C tiles of two neighbouring n8 blocks, rounded to bf16 and packed
// in pairs, are the A fragment of one k16 step of the next product.

#pragma once
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

typedef __nv_bfloat16 bf16;

namespace {

// 16-byte global->shared copy; when pred is false the 16 bytes are zeroed.
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem, bool pred) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(s), "l"(gmem), "r"(n));
}
__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::); }
__device__ __forceinline__ void cp_async_wait1() { asm volatile("cp.async.wait_group 1;\n" ::); }

// Two fp32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
