// The tensor-core and async-copy building blocks of the bf16 attention
// forward K2 (flash_attention.cu) and of the fp32 FMA bodies of K1 and K6
// (cp.async); K1, K6 and the attention backward run bf16 on wgmma and TMA
// (hopper.cuh).
// All of them are sm_80+ instructions that Hopper keeps: cp.async for
// global -> shared copies, ldmatrix to load mma.sync fragments from shared
// memory, and mma.sync m16n8k16 bf16 -> fp32.
//
// Fragment layout of mma.sync.m16n8k16 (lane = 4 g + t4):
//   A (16 x 16, row-major): a0 = (g, 2t4..2t4+1), a1 = (g+8, 2t4..),
//     a2 = (g, 2t4+8..), a3 = (g+8, 2t4+8..), two bf16 per register;
//   B (16 x 8, k x n):      b0 = (k 2t4..2t4+1, n g), b1 = (k 2t4+8.., n g);
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
__device__ __forceinline__ void cp_async_wait0() { asm volatile("cp.async.wait_group 0;\n" ::); }

__device__ __forceinline__ void mma_bf16(float* c, const uint32_t* a, const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// Four 8 x 8 bf16 matrices from shared memory; lanes 8m..8m+7 give the row
// addresses of matrix m, and register m receives it in the fragment layout
// above (row lane / 4, columns 2 (lane % 4)..+1).
__device__ __forceinline__ void ldmatrix_x4(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// The same, each matrix transposed: register m holds (rows 2 (lane % 4)..+1,
// column lane / 4) of matrix m, i.e. a B fragment of a k-major operand.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(s));
}
// Two transposed matrices; lanes 0..15 give the row addresses.
__device__ __forceinline__ void ldmatrix_x2_trans(uint32_t* r, const void* smem) {
  unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.trans.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(s));
}

// Two fp32 values rounded to bf16 and packed, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

}  // namespace
