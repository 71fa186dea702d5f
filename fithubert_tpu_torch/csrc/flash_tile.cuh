// The tile steps of the bf16 attention forward K2 (flash_attention.cu) on
// mma.sync: a block of 4 warps holds 64-row tiles of (T, D) bf16 operands
// in shared memory; each warp owns 16 rows of the other operand as mma.sync
// fragments in registers. The design notes are in flash_attention.cu. The
// head sizes and the shared-memory opt-in also serve the backward
// (flash_attention_bwd.cu).

#pragma once
#include <cuda_runtime.h>

#include "mma.cuh"

// The head sizes the attention kernels are compiled for (HEAD_DIMS in
// ops/kernels/flash_attention.py, which zero-pads any other D up to 128 to
// the next of them): X(D) once per size.
#define FA_HEAD_DIMS(X) X(16) X(32) X(40) X(48) X(64) X(80) X(96) X(128)

namespace {

constexpr int TILE = 64;  // rows of a staged tile: queries or keys

// The kernels carve their tiles from dynamic shared memory, so the tiles of
// the larger head sizes may pass the 48 KB of static shared memory; a
// kernel takes more than 48 KB only after opting in, once per process.
template <typename Kernel>
inline void opt_in_smem(Kernel kernel, int bytes, bool& done) {
  if (!done && bytes > 48 * 1024)
    cudaFuncSetAttribute(reinterpret_cast<const void*>(kernel),
                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = true;
}

// How a (TILE, D) bf16 tile sits in shared memory.
template <int D>
struct Rows {
  static_assert(D % 8 == 0, "rows are copied in 16-byte chunks");
  static constexpr int DP = (D + 15) / 16 * 16;  // k extent of a product over D
  static constexpr int LD = DP + 8;  // row pitch: an odd number of 16-byte units, so the
                                     // 8 row addresses of an ldmatrix hit distinct banks
  static constexpr int N8 = D / 8;   // 16-byte chunks of a row; n8 tiles of a (16, D) result
  static constexpr int KS = DP / 16;  // k16 steps of a product over D
  static constexpr int BYTES = TILE * LD * 2;  // one staged (TILE, D) tile
};

// Zero columns D..DP-1 of n_rows rows: the last k16 step over D reads them,
// and no copy ever writes them.
template <int D>
__device__ __forceinline__ void zero_pad(bf16 (*rows)[Rows<D>::LD], int n_rows) {
  constexpr int PADC = (Rows<D>::DP - D) / 8;
  if constexpr (PADC > 0) {
    for (int e = threadIdx.x; e < n_rows * PADC; e += blockDim.x)
      *reinterpret_cast<uint4*>(&rows[e / PADC][D + 8 * (e % PADC)]) =
          make_uint4(0u, 0u, 0u, 0u);
  }
}

// Start the cp.async copies of rows t0 .. t0 + TILE - 1 of a (T, D) operand
// whose row t starts at src + t * row_stride; rows past T are zero-filled.
template <int D>
__device__ __forceinline__ void load_rows(bf16 (*dst)[Rows<D>::LD], const bf16* src,
                                          long long row_stride, int t0, int T_len) {
  constexpr int N8 = Rows<D>::N8;
  for (int e = threadIdx.x; e < TILE * N8; e += blockDim.x) {
    const int r = e / N8, c = 8 * (e - r * N8), t = t0 + r;
    const bool ok = t < T_len;
    cp_async16(&dst[r][c], src + static_cast<long long>(ok ? t : 0) * row_stride + c, ok);
  }
}

// A (16, DP) held as KS A fragments, times the transpose of a (TILE, DP)
// tile B in shared memory: c = A B^T, 8 n8 tiles of (16, TILE), fp32.
template <int D>
__device__ __forceinline__ void mma_a_bt(float (&c)[8][4], const uint32_t (&a)[Rows<D>::KS][4],
                                         const bf16 (*B)[Rows<D>::LD], int lane) {
#pragma unroll
  for (int n = 0; n < 8; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) c[n][e] = 0.f;
#pragma unroll
  for (int ks = 0; ks < Rows<D>::KS; ++ks)
#pragma unroll
    for (int np = 0; np < 4; ++np) {  // rows 16 np .. 16 np + 15 of B
      uint32_t bf[4];
      ldmatrix_x4(bf, &B[np * 16 + (lane & 7) + ((lane >> 4) << 3)]
                        [ks * 16 + ((lane >> 3) & 1) * 8]);
      mma_bf16(c[2 * np], a[ks], bf);
      mma_bf16(c[2 * np + 1], a[ks], bf + 2);
    }
}

// acc += A B: A (16, TILE) the 8 fp32 C tiles of a product like mma_a_bt's,
// rounded to bf16 and fed from registers (tiles 2kk and 2kk + 1 are the A
// fragment of k16 step kk); B a (TILE, D) tile in shared memory, read with
// ldmatrix.trans. acc holds the N8 n8 tiles of (16, D), fp32.
template <int D>
__device__ __forceinline__ void mma_c_b(float (&acc)[Rows<D>::N8][4], const float (&a)[8][4],
                                        const bf16 (*B)[Rows<D>::LD], int lane) {
  constexpr int N8 = Rows<D>::N8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t pa[4] = {pack_bf16(a[2 * kk][0], a[2 * kk][1]),
                            pack_bf16(a[2 * kk][2], a[2 * kk][3]),
                            pack_bf16(a[2 * kk + 1][0], a[2 * kk + 1][1]),
                            pack_bf16(a[2 * kk + 1][2], a[2 * kk + 1][3])};
    const int r = kk * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
#pragma unroll
    for (int dp = 0; dp < N8 / 2; ++dp) {
      uint32_t bf[4];
      ldmatrix_x4_trans(bf, &B[r][dp * 16 + (lane >> 4) * 8]);
      mma_bf16(acc[2 * dp], pa, bf);
      mma_bf16(acc[2 * dp + 1], pa, bf + 2);
    }
    if (N8 & 1) {
      uint32_t bf[2];
      ldmatrix_x2_trans(bf, &B[r][(N8 - 1) * 8]);
      mma_bf16(acc[N8 - 1], pa, bf);
    }
  }
}

// The A fragments of rows row0 .. row0 + 15 of a tile in shared memory.
template <int D>
__device__ __forceinline__ void load_a(uint32_t (&a)[Rows<D>::KS][4],
                                       const bf16 (*rows)[Rows<D>::LD], int row0, int lane) {
#pragma unroll
  for (int ks = 0; ks < Rows<D>::KS; ++ks)
    ldmatrix_x4(a[ks], &rows[row0 + (lane & 15)][ks * 16 + (lane >> 4) * 8]);
}

}  // namespace
