// What the attention kernels share: the forward K2 (flash_attention.cu) and
// the backward (flash_attention_bwd.cu). The head sizes they are compiled
// for, their argument structs, the TMA map of a (B, T, H, D) operand, the
// shared-memory opt-in, the register-plan error code of the kernels that
// move registers with setmaxnreg, and exp2 on the special-function unit.

#pragma once
#include <cuda_runtime.h>
#include <stdint.h>

#include "hopper.cuh"
#include "mma.cuh"

// The head sizes the attention kernels are compiled for (HEAD_DIMS in
// ops/kernels/flash_attention.py, which zero-pads any other D up to 128 to
// the next of them): X(D) once per size.
#define FA_HEAD_DIMS(X) X(16) X(32) X(40) X(48) X(64) X(80) X(96) X(128)

namespace {

// The (b, t, h) element strides of q, k and v; unit stride along D.
struct Strides {
  long long qb, qt, qh, kb, kt, kh, vb, vt, vh;
};

struct Dropout {
  uint32_t thr;  // floor(p * 2^24); 0 = no dropout
  float inv_keep;
  const uint32_t* ptr;  // the seed's two words in device memory (null: no dropout)
  uint32_t seed0, seed1;  // read from ptr as each block starts
};

// The fp32 bodies carve their tiles from dynamic shared memory, so the
// tiles of the larger head sizes may pass the 48 KB of static shared
// memory; a kernel takes more than 48 KB only after opting in, once per
// process.
template <typename Kernel>
inline void opt_in_smem(Kernel kernel, int bytes, bool& done) {
  if (!done && bytes > 48 * 1024)
    cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = true;
}

// The same for the wgmma kernels, whose shared memory always passes 48 KB,
// returning the error where the attribute is refused.
template <typename Kernel>
int allow_smem(Kernel kernel, int bytes, bool* done) {
  if (!*done) {
    const cudaError_t e =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    *done = true;
  }
  return 0;
}

// A kernel built with another register count than its setmaxnreg plan
// (REG_ERROR + the count): launched, its consumers could wait forever for
// registers the block does not hold.
constexpr int REG_ERROR = 300000;

// Whether a kernel was built with the register count its setmaxnreg plan
// assumes: 0, REG_ERROR + the count, or the error of the query.
template <typename Kernel>
int check_regs(Kernel kernel, int launch_regs) {
  cudaFuncAttributes attr;
  const cudaError_t e = cudaFuncGetAttributes(&attr, kernel);
  if (e != cudaSuccess) return static_cast<int>(e);
  return attr.numRegs == launch_regs ? 0 : REG_ERROR + attr.numRegs;
}

// A 4-D map (D, T, H, B) of a bf16 (B, T, H, D) tensor with the given (b,
// t, h) element strides, [64 rows][64 columns] boxes under the 128-byte
// swizzle: columns past D and rows past T load as zeros. A dimension of
// length 1 is never stepped, so any valid stride stands in for its own.
int map_rows(CUtensorMap* map, const bf16* x, int d, int B, int T_len, int H, long long sb,
             long long st_, long long sh) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(d), static_cast<cuuint64_t>(T_len),
                              static_cast<cuuint64_t>(H), static_cast<cuuint64_t>(B)};
  auto bytes = [](long long s, int n) { return static_cast<cuuint64_t>(n > 1 ? 2 * s : 16); };
  const cuuint64_t strides[3] = {bytes(st_, T_len), bytes(sh, H), bytes(sb, B)};
  const cuuint32_t box[4] = {64, 64, 1, 1};
  return encode_map(map, x, 4, dims, strides, box);
}

// 2^x on the special-function unit, subnormal results flushed to zero (a
// probability below 2^-126 adds nothing a bf16 operand could hold):
// exp2f's handling of them made the fused backward measurably slower on the
// card.
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace
